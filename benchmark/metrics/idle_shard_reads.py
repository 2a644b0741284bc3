"""idle_shard_reads: the share, in percent, of the GET threads' time
during the card's idle time in which a thread's innermost span was
`ec.pread` or `ec.gather`."""

from benchmark import spanclock


def read(run):
    return spanclock.idle_share(run, ("ec.pread", "ec.gather"))
