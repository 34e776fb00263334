"""PostgreSQL wire-protocol shim server backed by SQLite (the port's own
copy of musicfpaugment_tpu/afp/dejavu/pg_shim.py).

Where no Postgres server runs, the shim lets
:class:`~musicfpaugment_torch.afp.dejavu.postgres_database.PostgreSQLDatabase`
run over a real TCP socket on localhost through a real client library
(psycopg2 or the bundled ctypes :mod:`pglib`). It speaks enough of the v3
wire protocol: startup/auth, simple query (``PQexec``) and the extended
Parse/Bind/Describe/Execute/Sync flow (``PQexecParams``), with storage in
SQLite.

It translates exactly the dialect surface PostgreSQLDatabase issues:
``SERIAL PRIMARY KEY``, ``RETURNING``, ``ON CONFLICT DO NOTHING``,
``encode(x, 'hex')`` / ``decode(x, 'hex')``, ``now()``, ``DROP ...
CASCADE``. It is a test double with real sockets and a real client
library, not a general SQL server.

Run standalone:
    python -m musicfpaugment_torch.afp.dejavu.pg_shim --port 5999 --db fma.sqlite
then point the dejavu config at
``host=127.0.0.1 port=5999 dbname=fma user=shim``.
"""

from __future__ import annotations

import argparse
import re
import socket
import sqlite3
import struct
import threading
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

_SSL_REQUEST = 80877103
_GSS_REQUEST = 80877104
_CANCEL_REQUEST = 80877102

# result-column type OIDs (drive pglib/psycopg2 text->python conversion)
_OID_INT8 = 20
_OID_FLOAT8 = 701
_OID_BYTEA = 17
_OID_TEXT = 25


def _translate(sql: str) -> str:
    """Postgres dialect -> SQLite for the PostgreSQLDatabase SQL surface."""
    out = re.sub(
        r"\bSERIAL\s+PRIMARY\s+KEY\b",
        "INTEGER PRIMARY KEY AUTOINCREMENT",
        sql,
        flags=re.I,
    )
    out = re.sub(r"\bDEFAULT\s+now\(\)", "DEFAULT CURRENT_TIMESTAMP", out, flags=re.I)
    out = re.sub(r"\bDROP\s+TABLE\s+IF\s+EXISTS\s+(\w+)\s+CASCADE",
                 r"DROP TABLE IF EXISTS \1", out, flags=re.I)
    out = re.sub(r"\$(\d+)", r":p\1", out)  # $n -> named sqlite params
    return out


def _coerce(value: Optional[str]) -> Any:
    """Text-format wire param -> binding value. Bind the TEXT verbatim:
    SQLite column affinity converts '5' to 5 for INTEGER columns on both
    insert and comparison (exactly what Postgres' context-driven param
    typing achieves), while an eager int() cast would corrupt all-digit
    VARCHAR data — a fingerprint hash '00123' must keep its leading zeros
    or dejavu's return_matches dict lookup misses it."""
    return value


def _text(value: Any) -> bytes:
    """Python value -> postgres text-format field bytes."""
    if isinstance(value, bool):
        return b"t" if value else b"f"
    if isinstance(value, (bytes, memoryview)):
        return b"\\x" + bytes(value).hex().encode()
    return str(value).encode()


def _oid_for(value: Any) -> int:
    if isinstance(value, bool):
        return _OID_TEXT
    if isinstance(value, int):
        return _OID_INT8
    if isinstance(value, float):
        return _OID_FLOAT8
    if isinstance(value, (bytes, memoryview)):
        return _OID_BYTEA
    return _OID_TEXT


def _command_tag(sql: str, rowcount: int, nrows: int) -> bytes:
    word = (sql.split() or ["?"])[0].upper()
    if word == "SELECT":
        return f"SELECT {nrows}".encode()
    if word == "INSERT":
        return f"INSERT 0 {max(rowcount, 0)}".encode()
    if word in ("UPDATE", "DELETE"):
        return f"{word} {max(rowcount, 0)}".encode()
    second = (sql.split()[1].upper() if len(sql.split()) > 1 else "").rstrip(";")
    if word in ("CREATE", "DROP") and second in ("TABLE", "INDEX"):
        return f"{word} {second}".encode()
    return word.encode()


class _Handler(threading.Thread):
    def __init__(self, server: "PGShimServer", conn: socket.socket) -> None:
        super().__init__(daemon=True)
        self._srv = server
        self._sock = conn
        self._buf = b""
        self._stmts: Dict[bytes, str] = {}
        self._portals: Dict[bytes, Tuple[str, Dict[str, Any]]] = {}
        self._skip_until_sync = False

    # ------------------------------------------------------------ io
    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("client closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _send(self, msg_type: bytes, payload: bytes = b"") -> None:
        self._sock.sendall(msg_type + struct.pack("!I", len(payload) + 4) + payload)

    def _ready(self) -> None:
        self._send(b"Z", b"I")

    def _error(self, message: str) -> None:
        fields = b"SERROR\x00VERROR\x00C42601\x00M" + message.encode(
            errors="replace"
        ) + b"\x00\x00"
        self._send(b"E", fields)

    # ------------------------------------------------------------ startup
    def _startup(self) -> bool:
        while True:
            (length,) = struct.unpack("!I", self._recv_exact(4))
            payload = self._recv_exact(length - 4)
            (code,) = struct.unpack("!I", payload[:4])
            if code in (_SSL_REQUEST, _GSS_REQUEST):
                self._sock.sendall(b"N")  # no SSL/GSS — proceed cleartext
                continue
            if code == _CANCEL_REQUEST:
                return False
            break  # protocol 3.0 StartupMessage
        self._send(b"R", struct.pack("!I", 0))  # AuthenticationOk
        for k, v in (("server_version", "14.0 (mfpa shim)"),
                     ("client_encoding", "UTF8")):
            self._send(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")
        self._send(b"K", struct.pack("!II", 1, 0))  # BackendKeyData
        self._ready()
        return True

    # ------------------------------------------------------------ exec
    def _execute(
        self, sql: str, params: Optional[Dict[str, Any]] = None
    ) -> Tuple[list, Optional[list], bytes]:
        rows, desc, rowcount = self._srv._run(sql, params)
        return rows, desc, _command_tag(sql, rowcount, len(rows))

    def _send_row_description(self, desc: list, rows: list) -> None:
        payload = struct.pack("!H", len(desc))
        for i, col in enumerate(desc):
            # Type each column from its first NON-NULL value across the
            # fetched rows — a NULL in row 0 must not demote an int column
            # to TEXT for the later non-null rows. All-null/empty -> TEXT.
            oid = _OID_TEXT
            for row in rows:
                if row[i] is not None:
                    oid = _oid_for(row[i])
                    break
            payload += col[0].encode() + b"\x00"
            payload += struct.pack("!IHIhih", 0, 0, oid, -1, -1, 0)
        self._send(b"T", payload)

    def _send_rows(self, rows: list) -> None:
        for row in rows:
            payload = struct.pack("!H", len(row))
            for v in row:
                if v is None:
                    payload += struct.pack("!i", -1)
                else:
                    data = _text(v)
                    payload += struct.pack("!i", len(data)) + data
            self._send(b"D", payload)

    # ------------------------------------------------------------ messages
    def _on_simple_query(self, payload: bytes) -> None:
        sql_script = payload.rstrip(b"\x00").decode()
        statements = [s.strip() for s in sql_script.split(";") if s.strip()]
        if not statements:
            self._send(b"I")  # EmptyQueryResponse
            self._ready()
            return
        try:
            for stmt in statements:
                rows, desc, tag = self._execute(stmt)
                if desc is not None:
                    self._send_row_description(desc, rows)
                    self._send_rows(rows)
                self._send(b"C", tag + b"\x00")
        except Exception as e:  # noqa: BLE001 — surface as wire error
            self._error(str(e))
        self._ready()

    def _on_parse(self, payload: bytes) -> None:
        name, rest = payload.split(b"\x00", 1)
        query, _rest = rest.split(b"\x00", 1)
        self._stmts[name] = query.decode()
        self._send(b"1")

    def _on_bind(self, payload: bytes) -> None:
        portal, rest = payload.split(b"\x00", 1)
        stmt, rest = rest.split(b"\x00", 1)
        off = 0
        (nfmt,) = struct.unpack_from("!H", rest, off)
        off += 2 + 2 * nfmt  # param format codes (text assumed)
        (nparams,) = struct.unpack_from("!H", rest, off)
        off += 2
        params: Dict[str, Any] = {}
        for i in range(nparams):
            (plen,) = struct.unpack_from("!i", rest, off)
            off += 4
            if plen < 0:
                params[f"p{i + 1}"] = None
            else:
                params[f"p{i + 1}"] = _coerce(rest[off : off + plen].decode())
                off += plen
        self._portals[portal] = (self._stmts.get(stmt, ""), params)
        self._send(b"2")

    def _on_describe(self, payload: bytes) -> None:
        # PG v3 semantics: Describe only reports the portal's row shape —
        # the statement's side effects happen at Execute, never here. The
        # shape (and the value-derived column OIDs) comes from a probe run
        # inside a rolled-back savepoint, so a client that Describes
        # without Executing leaves the database untouched and Execute runs
        # the statement exactly once.
        kind, name = payload[:1], payload[1:].split(b"\x00", 1)[0]
        if kind != b"P" or name not in self._portals:
            self._send(b"n")  # NoData
            return
        sql, params = self._portals[name]
        rows, desc = self._srv._probe(sql, params)
        if desc is not None:
            self._send_row_description(desc, rows)
        else:
            self._send(b"n")

    def _on_execute(self, payload: bytes) -> None:
        name = payload.split(b"\x00", 1)[0]
        sql, params = self._portals.get(name, ("", {}))
        rows, desc, tag = self._execute(sql, params)
        if desc is not None:
            self._send_rows(rows)
        self._send(b"C", tag + b"\x00")

    def run(self) -> None:  # pragma: no cover — exercised over sockets
        try:
            if not self._startup():
                return
            while True:
                msg_type = self._recv_exact(1)
                (length,) = struct.unpack("!I", self._recv_exact(4))
                payload = self._recv_exact(length - 4)
                if msg_type == b"X":
                    return
                if self._skip_until_sync and msg_type != b"S":
                    continue
                try:
                    if msg_type == b"Q":
                        self._on_simple_query(payload)
                    elif msg_type == b"P":
                        self._on_parse(payload)
                    elif msg_type == b"B":
                        self._on_bind(payload)
                    elif msg_type == b"D":
                        self._on_describe(payload)
                    elif msg_type == b"E":
                        self._on_execute(payload)
                    elif msg_type == b"S":
                        self._skip_until_sync = False
                        self._ready()
                    elif msg_type == b"H":  # Flush — writes are immediate
                        pass
                    else:  # unsupported (COPY, function call, ...)
                        self._error(f"unsupported message {msg_type!r}")
                        self._skip_until_sync = True
                except Exception as e:  # noqa: BLE001
                    self._error(str(e))
                    self._skip_until_sync = msg_type != b"Q"
                    if msg_type == b"Q":
                        self._ready()
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                self._sock.close()
            except OSError:
                pass


class PGShimServer:
    """Listening shim; use as a context manager or ``start()``/``stop()``.

    ``port=0`` picks a free port (read it back from ``.port``). All
    connections share one SQLite database (``:memory:`` by default), with a
    lock serializing statements — the dejavu layer runs short single-row
    statements, so concurrency is not the point; protocol fidelity is.
    """

    def __init__(
        self, db_path: str = ":memory:", host: str = "127.0.0.1", port: int = 0
    ) -> None:
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._lock = threading.Lock()
        self._db.create_function("now", 0, lambda: datetime.now(
            timezone.utc).strftime("%Y-%m-%d %H:%M:%S.%f"))
        self._db.create_function(
            "encode", 2,
            lambda b, fmt: bytes(b).hex() if b is not None else None,
        )
        self._db.create_function(
            "decode", 2,
            lambda s, fmt: bytes.fromhex(s) if s is not None else None,
        )
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._accept_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # ------------------------------------------------------------ sql
    def _run(
        self, sql: str, params: Optional[Dict[str, Any]] = None
    ) -> Tuple[list, Optional[list], int]:
        tsql = _translate(sql)
        with self._lock:
            cur = self._db.execute(tsql, params or {})
            desc = cur.description
            rows = cur.fetchall() if desc is not None else []
            rowcount = cur.rowcount
            self._db.commit()
        return rows, desc, rowcount

    def _probe(
        self, sql: str, params: Optional[Dict[str, Any]] = None
    ) -> Tuple[list, Optional[list]]:
        """Row-shape probe for Describe: run the statement inside a
        savepoint and roll it back, so column names and value-derived OIDs
        are exact while every side effect is undone (Execute then performs
        the statement exactly once)."""
        tsql = _translate(sql)
        with self._lock:
            self._db.execute("SAVEPOINT describe_probe")
            try:
                cur = self._db.execute(tsql, params or {})
                desc = cur.description
                rows = cur.fetchall() if desc is not None else []
            finally:
                self._db.execute("ROLLBACK TO describe_probe")
                self._db.execute("RELEASE describe_probe")
        return rows, desc

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "PGShimServer":
        self._listener.listen(8)

        def _accept() -> None:
            while not self._stopped.is_set():
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    return
                _Handler(self, conn).start()

        self._accept_thread = threading.Thread(target=_accept, daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def dsn(self, dbname: str = "fma", user: str = "shim") -> str:
        return f"host={self.host} port={self.port} dbname={dbname} user={user}"

    def __enter__(self) -> "PGShimServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", type=int, default=5999)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--db", default=":memory:", help="sqlite backing file")
    args = parser.parse_args()
    srv = PGShimServer(db_path=args.db, host=args.host, port=args.port).start()
    print(f"pg_shim listening — DSN: {srv.dsn()}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
