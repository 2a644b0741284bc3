"""device_idle: the share of the traced window, in percent, in which no
operation ran on the device (the union of the trace's kernels, copies
and fills is the busy time)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
