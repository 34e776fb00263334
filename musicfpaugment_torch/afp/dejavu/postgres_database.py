"""PostgreSQL backend (the port's own copy of
musicfpaugment_tpu/afp/dejavu/postgres_database.py). Connects through
psycopg2 when installed, otherwise through the bundled ctypes libpq client
(``pglib``: no Python dependency beyond the system ``libpq.so``).
``SQLiteDatabase`` stays the local default where no server runs."""

from __future__ import annotations

from contextlib import contextmanager

from musicfpaugment_torch.afp.dejavu.database import SQLDatabase


class PostgreSQLDatabase(SQLDatabase):
    type = "postgres"

    CREATE_SONGS_TABLE = """
        CREATE TABLE IF NOT EXISTS songs (
            song_id SERIAL PRIMARY KEY,
            song_name VARCHAR(250) NOT NULL,
            fingerprinted SMALLINT DEFAULT 0,
            file_sha1 BYTEA,
            total_hashes INT NOT NULL DEFAULT 0,
            date_created TIMESTAMP NOT NULL DEFAULT now(),
            date_modified TIMESTAMP NOT NULL DEFAULT now()
        );
    """
    CREATE_FINGERPRINTS_TABLE = """
        CREATE TABLE IF NOT EXISTS fingerprints (
            hash VARCHAR(30) NOT NULL,
            song_id INT NOT NULL REFERENCES songs(song_id) ON DELETE CASCADE,
            "offset" INT NOT NULL,
            date_created TIMESTAMP NOT NULL DEFAULT now(),
            date_modified TIMESTAMP NOT NULL DEFAULT now(),
            UNIQUE(song_id, "offset", hash)
        );
        CREATE INDEX IF NOT EXISTS ix_fingerprints_hash ON fingerprints(hash);
    """
    DROP_FINGERPRINTS = "DROP TABLE IF EXISTS fingerprints;"
    DROP_SONGS = "DROP TABLE IF EXISTS songs CASCADE;"
    DELETE_UNFINGERPRINTED = "DELETE FROM songs WHERE fingerprinted = 0;"
    SELECT_UNIQUE_SONG_IDS = (
        "SELECT COUNT(DISTINCT song_id) FROM songs WHERE fingerprinted = 1;"
    )
    SELECT_NUM_FINGERPRINTS = "SELECT COUNT(*) FROM fingerprints;"
    UPDATE_SONG_FINGERPRINTED = (
        "UPDATE songs SET fingerprinted = 1, date_modified = now() "
        "WHERE song_id = %s;"
    )
    SELECT_SONGS = (
        "SELECT song_id, song_name, encode(file_sha1, 'hex') AS file_sha1, "
        "total_hashes FROM songs WHERE fingerprinted = 1;"
    )
    SELECT_SONG = (
        "SELECT song_name, encode(file_sha1, 'hex') AS file_sha1, total_hashes "
        "FROM songs WHERE song_id = %s;"
    )
    INSERT_SONG = (
        "INSERT INTO songs (song_name, file_sha1, total_hashes) "
        "VALUES (%s, decode(%s, 'hex'), %s) RETURNING song_id;"
    )
    INSERT_FINGERPRINT = (
        "INSERT INTO fingerprints (song_id, hash, \"offset\") "
        "VALUES (%s, %s, %s) ON CONFLICT DO NOTHING;"
    )
    SELECT_MULTIPLE = (
        'SELECT hash, song_id, "offset" FROM fingerprints WHERE hash IN (%s);'
    )
    IN_MATCH = "%s"

    def __init__(self, **options) -> None:
        try:
            import psycopg2 as dbapi  # preferred when present
        except ImportError:
            from musicfpaugment_torch.afp.dejavu import pglib as dbapi

        self._options = options
        self._conn = dbapi.connect(**options)

    @contextmanager
    def cursor(self):
        cur = self._conn.cursor()
        try:
            yield cur
            self._conn.commit()
        finally:
            cur.close()

    def _last_song_id(self, cur) -> int:
        return int(cur.fetchone()[0])
