"""k1_roofline: K1's share of its bound, in percent: the least time the
HBM rate allows for the bytes the cell's transforms must move (each
input byte read once, each output byte written once; the operation's
`k1_bytes` counts them from the shapes it drove) over K1's device time
in the trace."""

from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(o.dur_us for o in run.trace.ops(roofline.K1_KERNEL)) / 1e6
    nbytes = run.op.k1_bytes(run)
    if not nbytes:
        return None
    return roofline.roofline_share(nbytes, kernel_s)
