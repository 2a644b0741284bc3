"""Cassandra filer store (driver-gated).

Reference: weed/filer2/cassandra/cassandra_store.go — table
filemeta(directory, name, meta) partitioned by directory. Registration
is skipped when the cassandra-driver package is absent.

A copy of seaweedfs_tpu/filer/stores/cassandra_store.py in the PyTorch port.
"""

from __future__ import annotations

import json

from cassandra.cluster import Cluster  # gated import

from ..entry import Entry
from ..filerstore import FilerStore, register_store


@register_store
class CassandraStore(FilerStore):
    name = "cassandra"

    def __init__(self, hosts: str = "localhost", keyspace: str = "seaweedfs",
                 **_):
        self._cluster = Cluster(hosts.split(","))
        self._s = self._cluster.connect()
        self._s.execute(
            f"CREATE KEYSPACE IF NOT EXISTS {keyspace} WITH replication="
            "{'class':'SimpleStrategy','replication_factor':1}")
        self._s.set_keyspace(keyspace)
        self._s.execute(
            "CREATE TABLE IF NOT EXISTS filemeta ("
            " directory text, name text, meta text,"
            " PRIMARY KEY (directory, name))")

    def _split(self, path: str) -> tuple[str, str]:
        p = path.rstrip("/") or "/"
        if p == "/":
            return "/", ""
        d, _, name = p.rpartition("/")
        return d or "/", name

    def insert_entry(self, entry: Entry) -> None:
        d, name = self._split(entry.full_path)
        self._s.execute(
            "INSERT INTO filemeta (directory, name, meta) VALUES (%s,%s,%s)",
            (d, name, json.dumps(entry.to_dict())))

    def update_entry(self, entry: Entry) -> None:
        self.insert_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        d, name = self._split(path)
        rows = self._s.execute(
            "SELECT meta FROM filemeta WHERE directory=%s AND name=%s",
            (d, name))
        row = rows.one()
        if row is None:
            return None
        return Entry.from_dict(json.loads(row.meta))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        self._s.execute(
            "DELETE FROM filemeta WHERE directory=%s AND name=%s", (d, name))

    def delete_folder_children(self, path: str) -> None:
        p = path.rstrip("/") or "/"
        for e in self.list_directory_entries(p, "", False, 1 << 30):
            if e.is_directory:
                self.delete_folder_children(e.full_path)
            self.delete_entry(e.full_path)

    def list_directory_entries(self, dir_path: str, start_file: str,
                               inclusive: bool, limit: int) -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        cmp = ">=" if inclusive else ">"
        rows = self._s.execute(
            f"SELECT meta FROM filemeta WHERE directory=%s AND name {cmp} %s "
            f"LIMIT {int(limit)}", (d, start_file))
        return [Entry.from_dict(json.loads(r.meta)) for r in rows]

    def close(self) -> None:
        self._cluster.shutdown()
