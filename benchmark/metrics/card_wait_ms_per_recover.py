"""card_wait_ms_per_recover: milliseconds of `ec.wait` spans (the host
waiting on the event recorded after the copy out) per card recover of
the traced window."""

from benchmark import spanclock


def read(run):
    return spanclock.per_card_recover(run, ("ec.wait",))
