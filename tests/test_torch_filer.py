"""Filer unit tests: chunk overlay algebra (filechunks_test.go tables),
store contract (leveldb_store_test.go pattern), filer core semantics.

The cases of tests/test_filer.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

import pytest

from seaweedfs_tpu_torch.filer.entry import Attr, Entry, new_directory_entry
from seaweedfs_tpu_torch.filer.filechunks import (
    FileChunk, minus_chunks, non_overlapping_visible_intervals, total_size,
    view_from_chunks)
from seaweedfs_tpu_torch.filer.filer import Filer, FilerError
from seaweedfs_tpu_torch.filer.filerstore import available_stores, create_store


def C(fid, off, size, mtime):
    return FileChunk(file_id=fid, offset=off, size=size, mtime=mtime)


class TestChunkAlgebra:
    def test_single_chunk(self):
        v = non_overlapping_visible_intervals([C("a", 0, 100, 1)])
        assert [(x.start, x.stop, x.file_id) for x in v] == [(0, 100, "a")]

    def test_full_overwrite(self):
        v = non_overlapping_visible_intervals(
            [C("a", 0, 100, 1), C("b", 0, 100, 2)])
        assert [(x.start, x.stop, x.file_id) for x in v] == [(0, 100, "b")]

    def test_partial_middle_overwrite(self):
        v = non_overlapping_visible_intervals(
            [C("a", 0, 100, 1), C("b", 30, 40, 2)])
        assert [(x.start, x.stop, x.file_id) for x in v] == [
            (0, 30, "a"), (30, 70, "b"), (70, 100, "a")]
        # tail interval must map to the right position INSIDE chunk a
        tail = v[2]
        assert tail.chunk_offset == 70

    def test_append_chunks(self):
        v = non_overlapping_visible_intervals(
            [C("a", 0, 50, 1), C("b", 50, 50, 2), C("c", 100, 7, 3)])
        assert [(x.start, x.stop) for x in v] == [(0, 50), (50, 100),
                                                 (100, 107)]
        assert total_size([C("a", 0, 50, 1), C("c", 100, 7, 3)]) == 107

    def test_mtime_order_not_list_order(self):
        v = non_overlapping_visible_intervals(
            [C("new", 0, 100, 5), C("old", 0, 100, 1)])
        assert v[0].file_id == "new"

    def test_views_clip(self):
        chunks = [C("a", 0, 100, 1), C("b", 30, 40, 2)]
        views = view_from_chunks(chunks, 25, 50)
        # 25-30 from a, 30-70 from b, 70-75 from a(offset 70)
        assert [(w.file_id, w.offset, w.size, w.logic_offset)
                for w in views] == [
            ("a", 25, 5, 25), ("b", 0, 40, 30), ("a", 70, 5, 70)]

    def test_views_beyond_eof(self):
        views = view_from_chunks([C("a", 0, 10, 1)], 8, 100)
        assert views == view_from_chunks([C("a", 0, 10, 1)], 8, 2)

    def test_minus_chunks(self):
        a = [C("x", 0, 1, 1), C("y", 1, 1, 1)]
        b = [C("y", 9, 9, 9)]
        assert [c.file_id for c in minus_chunks(a, b)] == ["x"]


@pytest.mark.parametrize("store_name", ["memory", "sqlite"])
class TestStoreContract:
    def _store(self, store_name, tmp_path):
        kwargs = {"path": str(tmp_path / "filer.db")} \
            if store_name == "sqlite" else {}
        return create_store(store_name, **kwargs)

    def test_crud(self, store_name, tmp_path):
        s = self._store(store_name, tmp_path)
        e = Entry("/a/b/file.txt", Attr(mtime=1.0, mime="text/plain"),
                  [C("3,01", 0, 10, 1)])
        s.insert_entry(e)
        got = s.find_entry("/a/b/file.txt")
        assert got.attr.mime == "text/plain"
        assert got.chunks[0].file_id == "3,01"
        e.attr.mime = "text/html"
        s.update_entry(e)
        assert s.find_entry("/a/b/file.txt").attr.mime == "text/html"
        s.delete_entry("/a/b/file.txt")
        assert s.find_entry("/a/b/file.txt") is None

    def test_listing_pagination(self, store_name, tmp_path):
        s = self._store(store_name, tmp_path)
        for name in ("a", "b", "c", "d", "e"):
            s.insert_entry(Entry(f"/dir/{name}", Attr(mtime=1.0)))
        page1 = s.list_directory_entries("/dir", "", False, 2)
        assert [e.name for e in page1] == ["a", "b"]
        page2 = s.list_directory_entries("/dir", "b", False, 10)
        assert [e.name for e in page2] == ["c", "d", "e"]
        page_inc = s.list_directory_entries("/dir", "b", True, 2)
        assert [e.name for e in page_inc] == ["b", "c"]

    def test_delete_folder_children(self, store_name, tmp_path):
        s = self._store(store_name, tmp_path)
        for p in ("/x/1", "/x/sub/2", "/x/sub/deep/3", "/y/other"):
            s.insert_entry(Entry(p, Attr(mtime=1.0)))
        s.delete_folder_children("/x")
        assert s.find_entry("/x/1") is None
        assert s.find_entry("/x/sub/2") is None
        assert s.find_entry("/x/sub/deep/3") is None
        assert s.find_entry("/y/other") is not None

    def test_root_listing(self, store_name, tmp_path):
        s = self._store(store_name, tmp_path)
        s.insert_entry(Entry("/top.txt", Attr(mtime=1.0)))
        got = s.list_directory_entries("/", "", False, 10)
        assert [e.name for e in got] == ["top.txt"]


def test_available_stores_includes_builtin():
    names = available_stores()
    assert "memory" in names and "sqlite" in names


class TestFilerCore:
    def test_create_makes_parents(self):
        f = Filer("memory")
        f.create_entry(Entry("/a/b/c/file", Attr(mtime=1.0)))
        assert f.find_entry("/a").is_directory
        assert f.find_entry("/a/b/c").is_directory
        kids = f.list_directory_entries("/a/b/c")
        assert [e.name for e in kids] == ["file"]

    def test_overwrite_deletes_old_chunks(self):
        f = Filer("memory")
        f.create_entry(Entry("/f", Attr(mtime=1.0), [C("1,aa", 0, 5, 1)]))
        f.create_entry(Entry("/f", Attr(mtime=2.0), [C("1,bb", 0, 9, 2)]))
        assert f.drain_pending_chunk_deletes() == ["1,aa"]

    def test_delete_recursive(self):
        f = Filer("memory")
        f.create_entry(Entry("/d/x", Attr(mtime=1.0), [C("1,aa", 0, 5, 1)]))
        f.create_entry(Entry("/d/sub/y", Attr(mtime=1.0),
                             [C("1,bb", 0, 5, 1)]))
        with pytest.raises(FilerError):
            f.delete_entry("/d")  # not empty, not recursive
        f.delete_entry("/d", recursive=True)
        assert f.find_entry("/d") is None
        assert sorted(f.drain_pending_chunk_deletes()) == ["1,aa", "1,bb"]

    def test_rename_tree(self):
        f = Filer("memory")
        f.create_entry(Entry("/old/a", Attr(mtime=1.0)))
        f.create_entry(Entry("/old/sub/b", Attr(mtime=1.0)))
        f.rename_entry("/old", "/new")
        assert f.find_entry("/old") is None
        assert f.find_entry("/new/a") is not None
        assert f.find_entry("/new/sub/b") is not None

    def test_file_over_directory_rejected(self):
        f = Filer("memory")
        f.create_entry(Entry("/d/x", Attr(mtime=1.0)))
        with pytest.raises(FilerError):
            f.create_entry(Entry("/d", Attr(mtime=1.0), [C("1,aa", 0, 1, 1)]))

    def test_notifications(self):
        f = Filer("memory")
        events = []
        f.listeners.append(lambda old, new: events.append(
            (old and old.full_path, new and new.full_path)))
        f.create_entry(Entry("/n", Attr(mtime=1.0)))
        f.delete_entry("/n")
        assert (None, "/n") in events and ("/n", None) in events
