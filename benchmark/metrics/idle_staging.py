"""idle_staging: the share, in percent, of the GET threads' time during
the card's idle time in which a thread's innermost span was `ec.stage`,
`ec.h2d` or `ec.d2h`."""

from benchmark import spanclock


def read(run):
    return spanclock.idle_share(run, ("ec.stage", "ec.h2d", "ec.d2h"))
