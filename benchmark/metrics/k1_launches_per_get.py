"""k1_launches_per_get: K1 launches counted by the program
(`ops/gf256_cuda.launches`) in the window, per GET completed in it."""


def read(run):
    clock = run.clock
    gets = len(run.outcome.in_window(clock.open, clock.close))
    if not gets or not run.outcome.launches:
        return None
    return run.outcome.launches / gets
