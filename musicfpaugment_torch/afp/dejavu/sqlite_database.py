"""SQLite backend: the Postgres schema and queries in SQLite's dialect,
always available locally (the port's own copy of
musicfpaugment_tpu/afp/dejavu/sqlite_database.py)."""

from __future__ import annotations

import sqlite3
from contextlib import contextmanager

from musicfpaugment_torch.afp.dejavu.database import SQLDatabase


class SQLiteDatabase(SQLDatabase):
    type = "sqlite"

    CREATE_SONGS_TABLE = """
        CREATE TABLE IF NOT EXISTS songs (
            song_id INTEGER PRIMARY KEY AUTOINCREMENT,
            song_name TEXT NOT NULL,
            fingerprinted INTEGER DEFAULT 0,
            file_sha1 TEXT,
            total_hashes INTEGER NOT NULL DEFAULT 0,
            date_created TEXT NOT NULL DEFAULT (datetime('now')),
            date_modified TEXT NOT NULL DEFAULT (datetime('now'))
        );
    """
    CREATE_FINGERPRINTS_TABLE = """
        CREATE TABLE IF NOT EXISTS fingerprints (
            hash TEXT NOT NULL,
            song_id INTEGER NOT NULL,
            offset INTEGER NOT NULL,
            date_created TEXT NOT NULL DEFAULT (datetime('now')),
            date_modified TEXT NOT NULL DEFAULT (datetime('now')),
            UNIQUE(song_id, offset, hash)
        );
    """
    CREATE_FINGERPRINTS_INDEX = (
        "CREATE INDEX IF NOT EXISTS ix_fingerprints_hash ON fingerprints(hash);"
    )
    DROP_FINGERPRINTS = "DROP TABLE IF EXISTS fingerprints;"
    DROP_SONGS = "DROP TABLE IF EXISTS songs;"
    DELETE_UNFINGERPRINTED = "DELETE FROM songs WHERE fingerprinted = 0;"
    SELECT_UNIQUE_SONG_IDS = (
        "SELECT COUNT(DISTINCT song_id) FROM songs WHERE fingerprinted = 1;"
    )
    SELECT_NUM_FINGERPRINTS = "SELECT COUNT(*) FROM fingerprints;"
    UPDATE_SONG_FINGERPRINTED = (
        "UPDATE songs SET fingerprinted = 1, date_modified = datetime('now') "
        "WHERE song_id = ?;"
    )
    SELECT_SONGS = (
        "SELECT song_id, song_name, file_sha1, total_hashes FROM songs "
        "WHERE fingerprinted = 1;"
    )
    SELECT_SONG = (
        "SELECT song_name, file_sha1, total_hashes FROM songs WHERE song_id = ?;"
    )
    INSERT_SONG = (
        "INSERT INTO songs (song_name, file_sha1, total_hashes) VALUES (?, ?, ?);"
    )
    INSERT_FINGERPRINT = (
        "INSERT OR IGNORE INTO fingerprints (song_id, hash, offset) "
        "VALUES (?, ?, ?);"
    )
    SELECT_MULTIPLE = (
        "SELECT hash, song_id, offset FROM fingerprints WHERE hash IN (%s);"
    )
    IN_MATCH = "?"

    def __init__(self, database: str = ":memory:", **_ignored) -> None:
        self._conn = sqlite3.connect(database)

    @contextmanager
    def cursor(self):
        cur = self._conn.cursor()
        try:
            yield cur
            self._conn.commit()
        finally:
            cur.close()

    def setup(self) -> None:
        super().setup()
        with self.cursor() as cur:
            cur.execute(self.CREATE_FINGERPRINTS_INDEX)

    def _last_song_id(self, cur) -> int:
        return int(cur.lastrowid)
