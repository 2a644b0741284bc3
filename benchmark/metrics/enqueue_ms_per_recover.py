"""enqueue_ms_per_recover: milliseconds of `ec.h2d` and `ec.d2h` spans
(the host enqueueing the copy in and the copy out) per card recover of
the traced window."""

from benchmark import spanclock


def read(run):
    return spanclock.per_card_recover(run, ("ec.h2d", "ec.d2h"))
