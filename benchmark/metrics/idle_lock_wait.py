"""idle_lock_wait: the share, in percent, of the GET threads' time during
the card's idle time (on the device trace's clock) in which a thread's
innermost span was `ec.lock_wait`."""

from benchmark import spanclock


def read(run):
    return spanclock.idle_share(run, ("ec.lock_wait",))
