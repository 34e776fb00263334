"""Minimal PostgreSQL client over the system ``libpq`` via ctypes (the
port's own copy of musicfpaugment_tpu/afp/dejavu/pglib.py).

It provides the small DB-API subset
:class:`~musicfpaugment_torch.afp.dejavu.postgres_database.PostgreSQLDatabase`
needs (cursor, execute with ``%s`` placeholders, executemany, fetchone/all,
commit) where psycopg2 is not installed. Statements run through
``PQexecParams`` (text results); integer-typed columns (int2/int4/int8
OIDs) are converted to ``int``.

Connections run in autocommit: each statement is its own transaction, which
matches how the dejavu layer uses its short-lived cursors (every cursor exit
commits, the ``cursor`` context manager of ``database.py``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Any, List, Optional, Sequence, Tuple

CONNECTION_OK = 0
PGRES_COMMAND_OK = 1
PGRES_TUPLES_OK = 2
_INT_OIDS = {20, 21, 23}  # int8, int2, int4
_FLOAT_OIDS = {700, 701, 1700}


class PGError(Exception):
    pass


_lib: Optional[ctypes.CDLL] = None


def _libpq() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("pq") or "libpq.so.5"
    lib = ctypes.CDLL(name)
    lib.PQconnectdb.argtypes = [ctypes.c_char_p]
    lib.PQconnectdb.restype = ctypes.c_void_p
    lib.PQstatus.argtypes = [ctypes.c_void_p]
    lib.PQstatus.restype = ctypes.c_int
    lib.PQerrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQerrorMessage.restype = ctypes.c_char_p
    lib.PQfinish.argtypes = [ctypes.c_void_p]
    lib.PQexecParams.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.PQexecParams.restype = ctypes.c_void_p
    lib.PQexec.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.PQexec.restype = ctypes.c_void_p
    lib.PQresultStatus.argtypes = [ctypes.c_void_p]
    lib.PQresultStatus.restype = ctypes.c_int
    lib.PQresultErrorMessage.argtypes = [ctypes.c_void_p]
    lib.PQresultErrorMessage.restype = ctypes.c_char_p
    lib.PQntuples.argtypes = [ctypes.c_void_p]
    lib.PQntuples.restype = ctypes.c_int
    lib.PQnfields.argtypes = [ctypes.c_void_p]
    lib.PQnfields.restype = ctypes.c_int
    lib.PQgetvalue.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.PQgetvalue.restype = ctypes.c_char_p
    lib.PQgetisnull.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.PQgetisnull.restype = ctypes.c_int
    lib.PQftype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.PQftype.restype = ctypes.c_uint
    lib.PQclear.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _to_dollar_params(sql: str) -> str:
    """``%s`` placeholders -> ``$1..$n`` (libpq's numbered style)."""
    out, n, i = [], 0, 0
    while i < len(sql):
        if sql.startswith("%s", i):
            n += 1
            out.append(f"${n}")
            i += 2
        else:
            out.append(sql[i])
            i += 1
    return "".join(out)


class Cursor:
    def __init__(self, conn: "Connection") -> None:
        self._conn = conn
        self._rows: List[Tuple[Any, ...]] = []
        self._pos = 0

    def execute(self, sql: str, params: Optional[Sequence[Any]] = None):
        self._rows = self._conn._exec(sql, params)
        self._pos = 0

    def executemany(self, sql: str, rows: Sequence[Sequence[Any]]):
        for row in rows:
            self._conn._exec(sql, row)

    def fetchone(self) -> Optional[Tuple[Any, ...]]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self) -> List[Tuple[Any, ...]]:
        rows = self._rows[self._pos :]
        self._pos = len(self._rows)
        return rows

    def close(self) -> None:
        pass

    def __iter__(self):
        return iter(self.fetchall())


class Connection:
    def __init__(self, dsn: str) -> None:
        lib = _libpq()
        self._pq = lib
        self._conn = lib.PQconnectdb(dsn.encode())
        if lib.PQstatus(self._conn) != CONNECTION_OK:
            msg = lib.PQerrorMessage(self._conn).decode(errors="replace")
            lib.PQfinish(self._conn)
            self._conn = None
            raise PGError(msg.strip() or "connection failed")

    def _exec(self, sql: str, params: Optional[Sequence[Any]] = None):
        lib = self._pq
        if params:
            sql = _to_dollar_params(sql)
            n = len(params)
            values = (ctypes.c_char_p * n)(
                *[None if p is None else str(p).encode() for p in params]
            )
            res = lib.PQexecParams(
                self._conn, sql.encode(), n, None, values, None, None, 0
            )
        else:
            # PQexec (not PQexecParams) so multi-statement DDL scripts work
            res = lib.PQexec(self._conn, sql.encode())
        try:
            status = lib.PQresultStatus(res)
            if status not in (PGRES_COMMAND_OK, PGRES_TUPLES_OK):
                raise PGError(
                    lib.PQresultErrorMessage(res).decode(errors="replace").strip()
                )
            rows: List[Tuple[Any, ...]] = []
            if status == PGRES_TUPLES_OK:
                nt, nf = lib.PQntuples(res), lib.PQnfields(res)
                oids = [lib.PQftype(res, c) for c in range(nf)]
                for r in range(nt):
                    row = []
                    for c in range(nf):
                        if lib.PQgetisnull(res, r, c):
                            row.append(None)
                            continue
                        v = lib.PQgetvalue(res, r, c).decode()
                        if oids[c] in _INT_OIDS:
                            row.append(int(v))
                        elif oids[c] in _FLOAT_OIDS:
                            row.append(float(v))
                        else:
                            row.append(v)
                    rows.append(tuple(row))
            return rows
        finally:
            lib.PQclear(res)

    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        pass  # autocommit: every statement is its own transaction

    def close(self) -> None:
        if self._conn is not None:
            self._pq.PQfinish(self._conn)
            self._conn = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def connect(**options) -> Connection:
    """psycopg2-style keyword options -> libpq DSN connection."""
    dsn = " ".join(f"{k}={v}" for k, v in options.items())
    return Connection(dsn)
