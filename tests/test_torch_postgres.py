"""The port's PostgreSQLDatabase (a copy of the JAX package's, with its own
ctypes ``pglib`` client and ``pg_shim`` wire-protocol server).

Two layers, as in tests/test_postgres.py:

* fake-connection tests exercise the Postgres dialect's SQL plumbing
  (cursor/commit lifecycle, RETURNING-based id fetch, IN-batch
  construction, offset-difference expansion) against a recording stub;
* live round-trips go through the real client library over a TCP socket on
  localhost to ``MFPA_POSTGRES_DSN`` when it is set, otherwise to the port's
  ``pg_shim``, the whole Dejavu flow included (``database_type:
  "postgres"``), fingerprints on the CPU.
"""

from __future__ import annotations

import os

import pytest

from musicfpaugment_torch.afp.dejavu.postgres_database import PostgreSQLDatabase

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


class FakeCursor:
    def __init__(self, log, results):
        self.log = log
        self._results = results
        self._last = None

    def execute(self, sql, params=None):
        self.log.append(("execute", sql.strip(), params))
        self._last = sql

    def executemany(self, sql, rows):
        self.log.append(("executemany", sql.strip(), list(rows)))

    def fetchone(self):
        return self._results.get("fetchone", (1,))

    def fetchall(self):
        key = "fetchall"
        for pattern, rows in self._results.items():
            if pattern != "fetchone" and pattern in (self._last or ""):
                return rows
        return self._results.get(key, [])

    def close(self):
        self.log.append(("close", None, None))


class FakeConn:
    def __init__(self, results=None):
        self.log = []
        self.commits = 0
        self._results = results or {}

    def cursor(self):
        return FakeCursor(self.log, self._results)

    def commit(self):
        self.commits += 1


def _make_db(results=None):
    db = PostgreSQLDatabase.__new__(PostgreSQLDatabase)  # skip psycopg2 connect
    db._conn = FakeConn(results)
    return db


def test_setup_runs_ddl_and_commits():
    db = _make_db()
    db.setup()
    sqls = [sql for op, sql, _ in db._conn.log if op == "execute"]
    assert any("CREATE TABLE IF NOT EXISTS songs" in s for s in sqls)
    assert any("CREATE TABLE IF NOT EXISTS fingerprints" in s for s in sqls)
    assert any("DELETE FROM songs WHERE fingerprinted = 0" in s for s in sqls)
    assert db._conn.commits == 1


def test_insert_song_returns_serial_id():
    db = _make_db({"fetchone": (42,)})
    sid = db.insert_song("track.mp3", "ab" * 20, 1234)
    assert sid == 42
    op, sql, params = db._conn.log[0]
    assert "RETURNING song_id" in sql
    assert params == ("track.mp3", "ab" * 20, 1234)


def test_insert_hashes_batches_and_uppercases():
    db = _make_db()
    hashes = [(f"{i:05x}", i) for i in range(2500)]
    db.insert_hashes(7, hashes, batch_size=1000)
    many = [(sql, rows) for op, sql, rows in db._conn.log if op == "executemany"]
    assert len(many) == 3  # 1000 + 1000 + 500
    assert all("ON CONFLICT DO NOTHING" in sql for sql, _ in many)
    assert many[0][1][0] == (7, "00000".upper(), 0)
    assert all(h == h.upper() for _, rows in many for (_, h, _) in rows)


def test_return_matches_in_batching_and_offset_expansion():
    # two query offsets for the same hash -> two expanded rows per db hit
    rows = [("AAAA", 3, 100), ("BBBB", 3, 50)]
    db = _make_db({"SELECT hash": rows})
    matches, dedup = db.return_matches(
        [("aaaa", 10), ("aaaa", 20), ("bbbb", 5)], batch_size=2
    )
    assert dedup == {3: 2}
    assert sorted(matches) == sorted([(3, 90), (3, 80), (3, 45)])
    q = [sql for op, sql, _ in db._conn.log if op == "execute"][0]
    assert "WHERE hash IN (%s, %s)" in q  # batch of 2 distinct hashes


def test_delete_songs_by_id_uses_in_lists():
    db = _make_db()
    db.delete_songs_by_id([1, 2, 3], batch_size=2)
    sqls = [sql for op, sql, _ in db._conn.log if op == "execute"]
    assert any("DELETE FROM fingerprints WHERE song_id IN (%s, %s)" in s for s in sqls)
    assert any("DELETE FROM songs WHERE song_id IN (%s)" in s for s in sqls)


def test_pglib_placeholder_conversion():
    from musicfpaugment_torch.afp.dejavu.pglib import _to_dollar_params

    assert _to_dollar_params("SELECT %s, %s") == "SELECT $1, $2"
    assert _to_dollar_params("IN (%s, %s, %s)") == "IN ($1, $2, $3)"
    assert _to_dollar_params("no params") == "no params"


@pytest.fixture
def live_db():
    """A PostgreSQLDatabase over a real wire connection: MFPA_POSTGRES_DSN
    when set (real server, e.g. the compose stack), else the bundled
    pg_shim wire-protocol server."""
    import re

    dsn = os.environ.get("MFPA_POSTGRES_DSN")
    if dsn:
        options = dict(
            part.split("=", 1)
            for part in re.split(r"\s+", dsn.strip())
            if "=" in part
        )
        try:
            yield PostgreSQLDatabase(**options)
        except Exception as e:
            pytest.skip(f"postgres unreachable: {e}")
        return
    from musicfpaugment_torch.afp.dejavu.pg_shim import PGShimServer

    with PGShimServer() as srv:
        options = dict(part.split("=", 1) for part in srv.dsn().split())
        yield PostgreSQLDatabase(**options)


def test_live_postgres_round_trip(live_db):
    # connects via psycopg2 when installed, else the ctypes libpq client
    db = live_db
    db.setup()
    db.empty()
    sid = db.insert_song("live.mp3", "cd" * 20, 4)
    # '00123' is all digits WITH leading zeros: a wire layer that coerces
    # numeric-looking text params to ints would store '123' and break the
    # return_matches dict lookup
    db.insert_hashes(
        sid, [("aaaa", 1), ("bbbb", 2), ("cccc", 3), ("00123", 4)]
    )
    db.set_song_fingerprinted(sid)
    assert db.get_num_songs() == 1
    assert db.get_num_fingerprints() == 4
    matches, dedup = db.return_matches([("aaaa", 0), ("00123", 1)])
    assert (sid, 1) in matches and (sid, 3) in matches and dedup[sid] == 2
    song = db.get_song_by_id(sid)
    assert song["song_name"] == "live.mp3"
    assert song["file_sha1"] == "cd" * 20
    db.delete_songs_by_id([sid])
    assert db.get_num_fingerprints() == 0


def test_live_postgres_dejavu_flow(live_db, tmp_path, rng):
    """The dejavu index + recognize flow with every DB statement crossing
    the wire: fingerprint a small wav corpus into the postgres backend, then
    recognize a crop through FileRecognizer."""
    import numpy as np
    import scipy.io.wavfile

    from musicfpaugment_torch.afp.dejavu import Dejavu, FileRecognizer

    sr = 8000
    tracks_dir = tmp_path / "tracks"
    tracks_dir.mkdir()
    paths, waves = [], []
    for i in range(3):
        t = np.arange(6 * sr)
        x = np.zeros(len(t), np.float32)
        for _ in range(150):
            f = rng.uniform(80, 3500)
            s = int(rng.integers(0, len(t) - sr // 8))
            seg = np.arange(int(rng.integers(sr // 16, sr // 4)))
            seg = seg[: len(t) - s]
            x[s : s + len(seg)] += (
                np.sin(2 * np.pi * f * seg / sr) * np.exp(-8 * seg / sr)
            ).astype(np.float32)
        x /= max(1e-6, np.abs(x).max())
        p = tracks_dir / f"song{i}.wav"
        scipy.io.wavfile.write(p, sr, (x * 32767).astype(np.int16))
        paths.append(str(p))
        waves.append(x)

    djv = Dejavu({}, state="set", db=live_db, device="cpu")
    djv.db.empty()
    djv.fingerprint_directory(paths)
    assert djv.db.get_num_songs() == 3
    assert djv.db.get_num_fingerprints() > 0

    crop = waves[1][sr : 3 * sr]
    result = FileRecognizer(djv).recognize_file(crop)
    assert result["match"] is True
    assert result["results"][0]["song_name"].decode() == "song1"


def test_shim_error_recovery():
    """A failing statement surfaces as a client-library error and the connection
    stays usable — both the simple-query (PQexec) and extended
    (PQexecParams) protocol paths."""
    from musicfpaugment_torch.afp.dejavu import pglib
    from musicfpaugment_torch.afp.dejavu.pg_shim import PGShimServer

    with PGShimServer() as srv:
        conn = pglib.connect(
            host=srv.host, port=srv.port, dbname="fma", user="shim"
        )
        cur = conn.cursor()
        with pytest.raises(pglib.PGError):
            cur.execute("SELECT * FROM missing_table;")
        with pytest.raises(pglib.PGError):
            cur.execute("SELECT * FROM missing_table WHERE a = %s;", (1,))
        cur.execute("SELECT 1 + 2 AS three;")
        assert cur.fetchone() == (3,)
        cur.execute(
            "CREATE TABLE t (a INT); INSERT INTO t VALUES (7); "
            "SELECT a FROM t;"
        )
        assert cur.fetchone() == (7,)
        conn.close()


def test_shim_describe_without_execute_has_no_side_effects():
    """PG v3 semantics: Describe reports the portal's row
    shape WITHOUT running the statement — a client that Describes and then
    Syncs (never Executes) must leave the database untouched, and a normal
    Describe+Execute flow must apply the statement exactly once. libpq
    always pairs the two, so this drives the wire by hand."""
    import socket
    import struct

    from musicfpaugment_torch.afp.dejavu.pg_shim import PGShimServer

    def send(sock, t, payload=b""):
        sock.sendall(t + struct.pack("!I", len(payload) + 4) + payload)

    def read_until_ready(sock):
        buf, msgs = b"", []
        while True:
            while len(buf) < 5:
                buf += sock.recv(65536)
            t, (n,) = buf[:1], struct.unpack("!I", buf[1:5])
            while len(buf) < 1 + n:
                buf += sock.recv(65536)
            msgs.append((t, buf[5 : 1 + n]))
            buf = buf[1 + n :]
            if t == b"Z":
                return msgs

    with PGShimServer() as srv:
        sock = socket.create_connection((srv.host, srv.port))
        start = b"user\x00shim\x00database\x00fma\x00\x00"
        sock.sendall(struct.pack("!II", len(start) + 8, 196608) + start)
        read_until_ready(sock)

        def simple(sql):
            send(sock, b"Q", sql.encode() + b"\x00")
            return read_until_ready(sock)

        simple("CREATE TABLE songs (song_id SERIAL PRIMARY KEY, name TEXT)")

        def extended(sql, execute):
            """Parse/Bind/Describe[/Execute]/Sync on the unnamed portal."""
            send(sock, b"P", b"\x00" + sql.encode() + b"\x00" + b"\x00\x00")
            send(sock, b"B", b"\x00\x00" + struct.pack("!HHH", 0, 0, 0))
            send(sock, b"D", b"P\x00")
            if execute:
                send(sock, b"E", b"\x00" + struct.pack("!i", 0))
            send(sock, b"S")
            return read_until_ready(sock)

        ins = "INSERT INTO songs (name) VALUES ('x') RETURNING song_id"
        msgs = extended(ins, execute=False)
        kinds = [t for t, _ in msgs]
        assert b"T" in kinds  # Describe still reports the RETURNING shape
        assert b"D" not in kinds and b"C" not in kinds  # ...but no rows ran

        count = lambda: [  # noqa: E731
            m for m in simple("SELECT count(*) FROM songs") if m[0] == b"D"
        ][0][1][-1:]
        assert count() == b"0"  # Describe-only left nothing behind

        msgs = extended(ins, execute=True)
        kinds = [t for t, _ in msgs]
        assert kinds.count(b"D") == 1 and b"C" in kinds
        assert count() == b"1"  # Describe+Execute inserted exactly once
        send(sock, b"X")
        sock.close()


def test_dejavu_config_selects_postgres():
    """``database_type: "postgres"`` makes Dejavu connect through the
    Postgres backend (imported only then) with ``database`` as its options;
    anything else is SQLite."""
    from musicfpaugment_torch.afp.dejavu import Dejavu, SQLiteDatabase
    from musicfpaugment_torch.afp.dejavu.pg_shim import PGShimServer

    with PGShimServer() as srv:
        options = dict(part.split("=", 1) for part in srv.dsn().split())
        djv = Dejavu({"database_type": "postgres", "database": options}, state="clear", device="cpu")
        assert isinstance(djv.db, PostgreSQLDatabase)
        sid = djv.db.insert_song("a", "ab" * 20, 1)
        djv.db.set_song_fingerprinted(sid)
        assert Dejavu({"database_type": "postgres", "database": options}, device="cpu").songhashes_set == {"ab" * 20}
    assert isinstance(Dejavu({}, device="cpu").db, SQLiteDatabase)
