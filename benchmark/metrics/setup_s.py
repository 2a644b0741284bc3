"""setup_s: seconds from the process's start to the end of the program's
set-up: importing torch, the seed's data, the store's writes, the
encode, the mount, the kernels' first build, the warm-up. The
benchmark's own host probes and the profiler's start, between it and
the window's opening, are left out."""


def read(run):
    return run.setup_s
