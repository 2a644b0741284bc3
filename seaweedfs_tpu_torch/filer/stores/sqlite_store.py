"""SQLite filer store — the embedded durable store.

Plays the role of the reference's leveldb2 default (8-way sharded leveldb,
filer2/leveldb2/leveldb2_store.go) and shares its schema idea with
abstract_sql (filer2/abstract_sql/abstract_sql_store.go): rows keyed by
(directory, name) with a serialized meta blob, so directory listings are an
indexed range scan.

A copy of seaweedfs_tpu/filer/stores/sqlite_store.py in the PyTorch port.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading

from ..entry import Entry
from ..filerstore import FilerStore, register_store


@register_store
class SqliteStore(FilerStore):
    name = "sqlite"

    def __init__(self, path: str = "filer.db", **_):
        self.path = path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._local = threading.local()
        with self._conn() as c:
            c.execute("""CREATE TABLE IF NOT EXISTS filemeta (
                directory TEXT NOT NULL,
                name TEXT NOT NULL,
                meta TEXT NOT NULL,
                PRIMARY KEY (directory, name))""")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.isolation_level = None  # autocommit
            self._local.conn = conn
        return conn

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        p = path.rstrip("/") or "/"
        if p == "/":
            return "", "/"
        d, _, n = p.rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        self._conn().execute(
            "INSERT OR REPLACE INTO filemeta (directory,name,meta) "
            "VALUES (?,?,?)", (d, n, json.dumps(entry.to_dict())))

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        d, n = self._split(path)
        row = self._conn().execute(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            (d, n)).fetchone()
        if row is None:
            return None
        return Entry.from_dict(json.loads(row[0]))

    def delete_entry(self, path: str) -> None:
        d, n = self._split(path)
        self._conn().execute(
            "DELETE FROM filemeta WHERE directory=? AND name=?", (d, n))

    def count_entries(self) -> int:
        row = self._conn().execute(
            "SELECT COUNT(*) FROM filemeta WHERE name != '/'").fetchone()
        return int(row[0])

    def delete_folder_children(self, path: str) -> None:
        p = path.rstrip("/") or "/"
        esc = p.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
        like = "/%" if p == "/" else esc + "/%"
        self._conn().execute(
            "DELETE FROM filemeta WHERE directory=? OR directory LIKE ? "
            "ESCAPE '\\'", (p, like))

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        op = ">=" if inclusive else ">"
        rows = self._conn().execute(
            f"SELECT meta FROM filemeta WHERE directory=? AND name {op} ? "
            f"ORDER BY name LIMIT ?", (d, start_file, limit)).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
