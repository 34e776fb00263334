"""Dejavu database layer: the abstract base, the SQL shared by the SQLite
and Postgres backends (the port's own copy of
musicfpaugment_tpu/afp/dejavu/database.py, which has no JAX in it).

``return_matches`` batches its IN-query at 500 hashes; the results are the
same as one hash at a time.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Tuple


class BaseDatabase(object, metaclass=abc.ABCMeta):
    """The backend interface of the dejavu layer."""

    type: str = ""

    def before_fork(self) -> None:
        pass

    def after_fork(self) -> None:
        pass

    def setup(self) -> None:
        pass

    @abc.abstractmethod
    def empty(self) -> None: ...

    @abc.abstractmethod
    def delete_unfingerprinted_songs(self) -> None: ...

    @abc.abstractmethod
    def get_num_songs(self) -> int: ...

    @abc.abstractmethod
    def get_num_fingerprints(self) -> int: ...

    @abc.abstractmethod
    def set_song_fingerprinted(self, song_id: int) -> None: ...

    @abc.abstractmethod
    def get_songs(self) -> List[Dict[str, str]]: ...

    @abc.abstractmethod
    def get_song_by_id(self, song_id: int) -> Dict[str, str]: ...

    @abc.abstractmethod
    def insert_song(self, song_name: str, file_hash: str, total_hashes: int) -> int: ...

    @abc.abstractmethod
    def insert_hashes(self, song_id: int, hashes: List[Tuple[str, int]]) -> None: ...

    @abc.abstractmethod
    def return_matches(
        self, hashes: List[Tuple[str, int]]
    ) -> Tuple[List[Tuple[int, int]], Dict[int, int]]: ...


class SQLDatabase(BaseDatabase):
    """SQL shared by the backends. Subclasses define
    a ``cursor()`` context manager and the dialect's SQL constants."""

    # subclasses set these
    CREATE_SONGS_TABLE = ""
    CREATE_FINGERPRINTS_TABLE = ""
    DROP_FINGERPRINTS = ""
    DROP_SONGS = ""
    DELETE_UNFINGERPRINTED = ""
    SELECT_UNIQUE_SONG_IDS = ""
    SELECT_NUM_FINGERPRINTS = ""
    UPDATE_SONG_FINGERPRINTED = ""
    SELECT_SONGS = ""
    SELECT_SONG = ""
    INSERT_SONG = ""
    INSERT_FINGERPRINT = ""
    SELECT_MULTIPLE = ""
    IN_MATCH = "?"

    def setup(self) -> None:
        with self.cursor() as cur:
            cur.execute(self.CREATE_SONGS_TABLE)
            cur.execute(self.CREATE_FINGERPRINTS_TABLE)
            cur.execute(self.DELETE_UNFINGERPRINTED)

    def empty(self) -> None:
        with self.cursor() as cur:
            cur.execute(self.DROP_FINGERPRINTS)
            cur.execute(self.DROP_SONGS)
        self.setup()

    def delete_unfingerprinted_songs(self) -> None:
        with self.cursor() as cur:
            cur.execute(self.DELETE_UNFINGERPRINTED)

    def get_num_songs(self) -> int:
        with self.cursor() as cur:
            cur.execute(self.SELECT_UNIQUE_SONG_IDS)
            return int(cur.fetchone()[0])

    def get_num_fingerprints(self) -> int:
        with self.cursor() as cur:
            cur.execute(self.SELECT_NUM_FINGERPRINTS)
            return int(cur.fetchone()[0])

    def set_song_fingerprinted(self, song_id: int) -> None:
        with self.cursor() as cur:
            cur.execute(self.UPDATE_SONG_FINGERPRINTED, (song_id,))

    def get_songs(self) -> List[Dict[str, str]]:
        with self.cursor() as cur:
            cur.execute(self.SELECT_SONGS)
            return [
                {"song_id": r[0], "song_name": r[1], "file_sha1": r[2],
                 "total_hashes": r[3]}
                for r in cur.fetchall()
            ]

    def get_song_by_id(self, song_id: int) -> Dict[str, str]:
        with self.cursor() as cur:
            cur.execute(self.SELECT_SONG, (song_id,))
            r = cur.fetchone()
            if r is None:
                return {}
            return {"song_id": song_id, "song_name": r[0], "file_sha1": r[1],
                    "total_hashes": r[2]}

    def insert_song(self, song_name: str, file_hash: str, total_hashes: int) -> int:
        with self.cursor() as cur:
            cur.execute(self.INSERT_SONG, (song_name, file_hash, total_hashes))
            return self._last_song_id(cur)

    def insert_hashes(
        self, song_id: int, hashes: List[Tuple[str, int]], batch_size: int = 1000
    ) -> None:
        """Insert (song_id, HASH, offset) rows in batches of ``batch_size``."""
        values = [(song_id, hsh.upper(), int(offset)) for hsh, offset in hashes]
        with self.cursor() as cur:
            for index in range(0, len(values), batch_size):
                cur.executemany(
                    self.INSERT_FINGERPRINT, values[index : index + batch_size]
                )

    def return_matches(
        self, hashes: List[Tuple[str, int]], batch_size: int = 500
    ) -> Tuple[List[Tuple[int, int]], Dict[int, int]]:
        """(song_id, db offset - query offset) for every stored row of every
        queried hash, and per song the number of fetched rows (one per
        distinct hash, however many query offsets share it)."""
        mapper: Dict[str, List[int]] = {}
        for hsh, offset in hashes:
            mapper.setdefault(hsh.upper(), []).append(offset)
        values = list(mapper.keys())
        dedup_hashes: Dict[int, int] = {}
        results: List[Tuple[int, int]] = []
        with self.cursor() as cur:
            for index in range(0, len(values), batch_size):
                chunk = values[index : index + batch_size]
                query = self.SELECT_MULTIPLE % ", ".join([self.IN_MATCH] * len(chunk))
                cur.execute(query, chunk)
                for hsh, sid, offset in cur.fetchall():
                    dedup_hashes[sid] = dedup_hashes.get(sid, 0) + 1
                    for song_sampled_offset in mapper[hsh]:
                        results.append((sid, offset - song_sampled_offset))
        return results, dedup_hashes

    def get_iterable_kv_pairs(self):
        """All stored fingerprints."""
        with self.cursor() as cur:
            cur.execute(self.SELECT_MULTIPLE.replace("WHERE hash IN (%s)", ""))
            return list(cur.fetchall())

    def delete_songs_by_id(self, song_ids, batch_size: int = 1000) -> None:
        """Delete songs and their fingerprints."""
        with self.cursor() as cur:
            for index in range(0, len(song_ids), batch_size):
                chunk = song_ids[index : index + batch_size]
                marks = ", ".join([self.IN_MATCH] * len(chunk))
                cur.execute(
                    f"DELETE FROM fingerprints WHERE song_id IN ({marks});", chunk
                )
                cur.execute(f"DELETE FROM songs WHERE song_id IN ({marks});", chunk)

    # dialect hooks
    def cursor(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _last_song_id(self, cur) -> int:
        raise NotImplementedError
