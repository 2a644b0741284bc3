"""S3-Select-ish JSON query pushdown, evaluated inside the volume server.

Reference: weed/query/json/query_json.go:17-64 (`QueryJson`: scan JSON
documents/lines, apply a single field filter, project selected fields)
and weed/server/volume_grpc_query.go:12-67 (the `Query` RPC that streams
matching records for a list of file ids held by this volume server).

Documents are either one JSON object or JSONL (one object per line).
Filter operands follow the reference's comparison set: = != > >= < <=
plus `like` (substring match on the string form).

A copy of seaweedfs_tpu/query/json_query.py in the PyTorch port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator


OPERANDS = ("=", "!=", ">", ">=", "<", "<=", "like")


@dataclass
class Filter:
    field: str
    operand: str
    value: str

    @classmethod
    def from_dict(cls, d: dict | None) -> "Filter | None":
        if not d or not d.get("field"):
            return None
        return cls(field=d["field"], operand=d.get("operand", "="),
                   value=str(d.get("value", "")))


def get_path(doc: Any, path: str) -> Any:
    """Dotted-path lookup (gjson-style, minus wildcards): `a.b.0.c`."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return None
            cur = cur[part]
        elif isinstance(cur, list):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return cur


def _compare(value: Any, op: str, operand: str) -> bool:
    if value is None:
        return False
    if op == "like":
        return operand in str(value)
    # numeric comparison when both sides parse as numbers, else string
    try:
        left: Any = float(value) if not isinstance(value, bool) else value
        right: Any = float(operand)
    except (TypeError, ValueError):
        left, right = str(value), operand
    if op == "=":
        return left == right
    if op == "!=":
        return left != right
    if op == ">":
        return left > right
    if op == ">=":
        return left >= right
    if op == "<":
        return left < right
    if op == "<=":
        return left <= right
    raise ValueError(f"unknown operand {op!r}")


def _documents(data: bytes) -> Iterator[Any]:
    text = data.decode("utf-8", errors="replace").strip()
    if not text:
        return
    # whole-body JSON first (object or array of objects)
    try:
        doc = json.loads(text)
        if isinstance(doc, list):
            yield from doc
        else:
            yield doc
        return
    except json.JSONDecodeError:
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            continue


def query_json(data: bytes, flt: Filter | None,
               selections: list[str] | None) -> list[dict]:
    """Return projected records from `data` matching `flt`."""
    out: list[dict] = []
    for doc in _documents(data):
        if not isinstance(doc, (dict, list)):
            continue
        if flt is not None and not _compare(
                get_path(doc, flt.field), flt.operand, flt.value):
            continue
        if selections:
            out.append({s: get_path(doc, s) for s in selections})
        else:
            out.append(doc if isinstance(doc, dict) else {"value": doc})
    return out
