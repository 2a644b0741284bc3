"""lock_wait_ms_per_get: milliseconds of `ec.lock_wait` spans (asking for
an `EcVolume._lock` until holding it) per GET of the traced window; none
where the spans are not on the device trace's clock (`spanclock`)."""

from benchmark import spanclock


def read(run):
    return spanclock.per_get(run, ("ec.lock_wait",))
