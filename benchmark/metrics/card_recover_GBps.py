"""card_recover_GBps: the bytes of lost shards that the card recovered
in the window (its device-to-host copies: each card recover copies its
recovered rows out once) over the seconds in which the card was busy
(the union of its kernels, copies and fills in the device trace)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    out = sum(o.nbytes for o in tr.ops("DtoH"))
    busy = tr.busy_s()
    if not out or busy <= 0:
        return None
    return out / busy / 1e9
