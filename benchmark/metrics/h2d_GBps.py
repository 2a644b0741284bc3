"""h2d_GBps: bytes of the host-to-device copies in the device trace over
the device time they took."""


def read(run):
    if run.trace is None:
        return None
    copies = [o for o in run.trace.ops("HtoD") if o.nbytes and o.dur_us]
    if not copies:
        return None
    return sum(o.nbytes for o in copies) / (
        sum(o.dur_us for o in copies) * 1e-6) / 1e9
