"""TOML parser shim: stdlib `tomllib` is 3.11+; fall back to the
third-party `tomli` (same API) and finally to None, which callers
treat as "config discovery disabled" instead of crashing every
command on an older interpreter.

A copy of seaweedfs_tpu/util/toml.py in the PyTorch port.
"""

from __future__ import annotations

try:
    import tomllib  # type: ignore[import-not-found]
except ModuleNotFoundError:  # pragma: no cover - version-dependent
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ModuleNotFoundError:
        tomllib = None  # type: ignore[assignment]
