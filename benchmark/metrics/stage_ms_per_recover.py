"""stage_ms_per_recover: milliseconds of `ec.stage` spans (the host copies
and pinned allocations of the survivors' block and the output) per card
recover (`ec.recover` with `path` "card") of the traced window."""

from benchmark import spanclock


def read(run):
    return spanclock.per_card_recover(run, ("ec.stage",))
