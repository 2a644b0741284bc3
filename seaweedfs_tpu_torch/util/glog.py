"""Leveled logging in the glog idiom.

Reference: weed/glog/ (vendored google/glog port, ~1,311 LoC): severity
levels INFO/WARNING/ERROR/FATAL, verbose `V(n)` guards compiled out by a
single integer comparison, `-v`/`-logtostderr` flags (weed.go:38,
glog.go:391+), size-based rotation of per-severity files.

Python re-expression: one module-level verbosity integer, `V(n)` returning
a no-op logger below threshold (so hot paths pay only an int compare), and
an optional log_dir with per-severity files rotated at max_size.

A copy of seaweedfs_tpu/util/glog.py in the PyTorch port.
"""

from __future__ import annotations

import io
import os
import sys
import threading
import time

INFO, WARNING, ERROR, FATAL = "INFO", "WARNING", "ERROR", "FATAL"
_SEVERITIES = (INFO, WARNING, ERROR, FATAL)

_verbosity = 0
_log_dir: str | None = None
_max_size = 64 << 20  # glog.MaxSize analog (set weed.go:38)
_lock = threading.Lock()
_files: dict[str, io.TextIOBase] = {}
_to_stderr = True


def init(verbosity: int = 0, log_dir: str | None = None,
         logtostderr: bool = True, max_size: int = 64 << 20) -> None:
    """Wire from CLI flags: -v, -logdir, -logtostderr."""
    global _verbosity, _log_dir, _to_stderr, _max_size
    _verbosity = verbosity
    _log_dir = log_dir
    _to_stderr = logtostderr or not log_dir
    _max_size = max_size
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)


def _emit(severity: str, msg: str) -> None:
    line = (f"{severity[0]}{time.strftime('%m%d %H:%M:%S')} "
            f"{threading.get_ident() % 100000:05d} {msg}\n")
    if _to_stderr:
        sys.stderr.write(line)
    if _log_dir:
        with _lock:
            f = _files.get(severity)
            if f is None or (f.tell() > _max_size):
                if f is not None:
                    f.close()
                path = os.path.join(
                    _log_dir,
                    f"swtpu.{severity}.{time.strftime('%Y%m%d-%H%M%S')}.log")
                f = open(path, "a")
                _files[severity] = f
            # glog semantics: a message at severity s lands in every file
            # of lower-or-equal severity; keep it simple with one file per
            # severity and write only there (queries use grep anyway)
            f.write(line)
            f.flush()


def info(fmt: str, *args) -> None:
    _emit(INFO, fmt % args if args else fmt)


def warning(fmt: str, *args) -> None:
    _emit(WARNING, fmt % args if args else fmt)


def error(fmt: str, *args) -> None:
    _emit(ERROR, fmt % args if args else fmt)


def fatal(fmt: str, *args) -> None:
    _emit(FATAL, fmt % args if args else fmt)
    raise SystemExit(255)


class _Verbose:
    """Returned by V(n); truthy + has infof, so both idioms work:

        if glog.V(3): ...expensive...
        glog.V(3).infof("read vid=%d nid=%d", vid, nid)
    """

    __slots__ = ("on",)

    def __init__(self, on: bool):
        self.on = on

    def __bool__(self) -> bool:
        return self.on

    def infof(self, fmt: str, *args) -> None:
        if self.on:
            _emit(INFO, fmt % args if args else fmt)


_V_ON = _Verbose(True)
_V_OFF = _Verbose(False)


def V(level: int) -> _Verbose:
    return _V_ON if level <= _verbosity else _V_OFF


def verbosity() -> int:
    return _verbosity
