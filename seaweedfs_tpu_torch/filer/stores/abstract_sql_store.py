"""Shared SQL store logic for the RDBMS-backed filer stores.

Reference: weed/filer2/abstract_sql/abstract_sql_store.go — one
`filemeta(dirhash, name, directory, meta)` table keyed by a 64-bit hash
of the parent directory plus the file name; mysql/ and postgres/ only
supply the connection + dialect. Here any DB-API 2.0 connection works
(sqlite3 in-tree; pymysql/psycopg2 when installed).

A copy of seaweedfs_tpu/filer/stores/abstract_sql_store.py in the PyTorch port.
"""

from __future__ import annotations

import hashlib
import json
import threading

from ..entry import Entry
from ..filerstore import FilerStore, register_store


def dir_hash(dir_path: str) -> int:
    """Signed 64-bit hash of the parent directory (abstract_sql's
    util.HashStringToLong equivalent, md5-based)."""
    h = hashlib.md5((dir_path.rstrip("/") or "/").encode()).digest()
    v = int.from_bytes(h[:8], "big", signed=True)
    return v


class AbstractSqlStore(FilerStore):
    """Works over any DB-API connection; subclasses pick driver+dialect."""

    name = "abstract_sql"
    placeholder = "?"        # sqlite/mysql use ?/%s, postgres uses %s/$n
    upsert_sql: str | None = None  # dialect-specific INSERT..ON CONFLICT

    def __init__(self, conn, **_):
        self._conn = conn
        self._lock = threading.RLock()
        self._create_table()

    def _create_table(self) -> None:
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS filemeta ("
                " dirhash BIGINT,"
                " name VARCHAR(1000),"
                " directory TEXT,"
                " meta TEXT,"
                " PRIMARY KEY (dirhash, name))")
            self._conn.commit()

    def _exec(self, sql: str, args: tuple = ()):
        return self._conn.execute(sql.replace("?", self.placeholder), args)

    # -- contract --

    def insert_entry(self, entry: Entry) -> None:
        d, name = entry.dir_path, entry.name
        if entry.full_path == "/":
            d, name = "/", ""
        meta = json.dumps(entry.to_dict())
        with self._lock:
            sql = self.upsert_sql or (
                "INSERT OR REPLACE INTO filemeta "
                "(dirhash, name, directory, meta) VALUES (?,?,?,?)")
            self._exec(sql, (dir_hash(d), name, d, meta))
            self._conn.commit()

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def _split(self, path: str) -> tuple[str, str]:
        p = path.rstrip("/") or "/"
        if p == "/":
            return "/", ""
        d, _, name = p.rpartition("/")
        return d or "/", name

    def find_entry(self, path: str) -> Entry | None:
        d, name = self._split(path)
        with self._lock:
            row = self._exec(
                "SELECT meta FROM filemeta WHERE dirhash=? AND name=? "
                "AND directory=?", (dir_hash(d), name, d)).fetchone()
        if row is None:
            return None
        return Entry.from_dict(json.loads(row[0]))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        with self._lock:
            self._exec("DELETE FROM filemeta WHERE dirhash=? AND name=? "
                       "AND directory=?", (dir_hash(d), name, d))
            self._conn.commit()

    def delete_folder_children(self, path: str) -> None:
        p = path.rstrip("/") or "/"
        with self._lock:
            # direct children + entire subtree rows (directory prefix)
            self._exec("DELETE FROM filemeta WHERE dirhash=? AND "
                       "directory=?", (dir_hash(p), p))
            like = ("/%" if p == "/" else p + "/%")
            self._exec("DELETE FROM filemeta WHERE directory LIKE ?",
                       (like,))
            self._conn.commit()

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        cmp = ">=" if inclusive else ">"
        with self._lock:
            rows = self._exec(
                f"SELECT meta FROM filemeta WHERE dirhash=? AND "
                f"directory=? AND name {cmp} ? AND name != '' "
                f"ORDER BY name LIMIT ?",
                (dir_hash(d), d, start_file, limit)).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def close(self) -> None:
        with self._lock:
            self._conn.close()


@register_store
class SqliteSqlStore(AbstractSqlStore):
    """sqlite3-backed abstract_sql instance (always available; stands in
    for the mysql/postgres pair in environments without those servers)."""

    name = "sql"

    def __init__(self, path: str = "./filer_sql.db", **_):
        import sqlite3
        super().__init__(sqlite3.connect(path, check_same_thread=False))


class MysqlStore(AbstractSqlStore):
    """Reference: weed/filer2/mysql/mysql_store.go (requires pymysql)."""

    name = "mysql"
    placeholder = "%s"
    upsert_sql = ("INSERT INTO filemeta (dirhash, name, directory, meta) "
                  "VALUES (?,?,?,?) ON DUPLICATE KEY UPDATE meta=VALUES(meta)")

    def __init__(self, host="localhost", port=3306, user="root",
                 password="", database="seaweedfs", **_):
        import pymysql
        conn = pymysql.connect(host=host, port=port, user=user,
                               password=password, database=database,
                               autocommit=False)
        super().__init__(_CursorConn(conn))


class PostgresStore(AbstractSqlStore):
    """Reference: weed/filer2/postgres/postgres_store.go (psycopg2)."""

    name = "postgres"
    placeholder = "%s"
    upsert_sql = ("INSERT INTO filemeta (dirhash, name, directory, meta) "
                  "VALUES (?,?,?,?) ON CONFLICT (dirhash, name) "
                  "DO UPDATE SET meta=EXCLUDED.meta")

    def __init__(self, host="localhost", port=5432, user="postgres",
                 password="", database="seaweedfs", **_):
        import psycopg2
        conn = psycopg2.connect(host=host, port=port, user=user,
                                password=password, dbname=database)
        super().__init__(_CursorConn(conn))


class _CursorConn:
    """Adapt client-server DB-API connections (execute lives on cursors)
    to the sqlite-style conn.execute(...) the shared code uses."""

    def __init__(self, conn):
        self._conn = conn

    def execute(self, sql, args=()):
        cur = self._conn.cursor()
        cur.execute(sql, args)
        return cur

    def commit(self):
        self._conn.commit()

    def close(self):
        self._conn.close()


def _register_if_driver(cls, module: str) -> None:
    try:
        __import__(module)
    except ImportError:
        return
    register_store(cls)


_register_if_driver(MysqlStore, "pymysql")
_register_if_driver(PostgresStore, "psycopg2")
