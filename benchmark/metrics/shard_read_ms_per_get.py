"""shard_read_ms_per_get: milliseconds of shard reads per GET of the
traced window: `ec.pread` (an intact interval's pread) and `ec.gather`
(a recover's survivor reads, local, cached or fetched)."""

from benchmark import spanclock


def read(run):
    return spanclock.per_get(run, ("ec.pread", "ec.gather"))
