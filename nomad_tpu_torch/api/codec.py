"""Struct <-> JSON-safe dict codec (a copy of ``nomad_tpu/api/codec.py``).

Dataclasses lower by a generic walk; dense numpy vectors serialize as
lists; objects carry no type tags because every API payload's shape is
known from its route. The API reads the store's host rows only: a torch
tensor reaching ``to_dict`` raises ``TypeError`` rather than serialize
(reading a CUDA value on a request thread would sync the card under a
worker's launch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type, get_args, get_origin

import numpy as np


def to_dict(obj: Any) -> Any:
    """Recursively lower structs/containers to JSON-safe values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        import base64

        return base64.b64encode(obj).decode("ascii")
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_dict(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name.startswith("_"):
                continue  # derived caches (Node._avail_vec) stay internal
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if type(obj).__module__.split(".")[0] == "torch":
        raise TypeError(f"a {type(obj).__name__} reached the API codec; "
                        "replies are built from the store's host rows")
    # objects with slots-based dataclasses already handled; fall back to str
    return str(obj)


def from_dict(cls: Type, data: Any) -> Any:
    """Inflate a dataclass (recursively) from a dict, tolerating missing
    and unknown keys — the API stays forward/backward compatible the way
    the reference's msgpack codec is."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        kwargs[f.name] = _inflate(hints[f.name], val, cls)
    return cls(**kwargs)


def _resolve(hint, owner_cls):
    """Resolve a string annotation to a runtime type. Doubly-quoted
    annotations ('"X | None"' under future-annotations) eval to a string
    once, so resolve until a non-string lands."""
    for _ in range(3):
        if not isinstance(hint, str):
            return hint
        hint = _resolve_once(hint, owner_cls)
    return hint


def _resolve_once(hint, owner_cls):
    if isinstance(hint, str):
        import sys
        import typing

        mod = sys.modules.get(owner_cls.__module__)
        ns = dict(vars(typing))
        ns.update(vars(mod) if mod else {})
        try:
            return eval(hint, ns)  # annotations are repo-controlled
        except Exception:
            return Any
    return hint


def _inflate(hint, val, owner_cls):
    hint = _resolve(hint, owner_cls)
    origin = get_origin(hint)
    if origin in (list, List):
        (item_t,) = get_args(hint) or (Any,)
        return [_inflate(item_t, v, owner_cls) for v in (val or [])]
    if origin in (dict, Dict):
        args = get_args(hint)
        item_t = args[1] if len(args) == 2 else Any
        return {k: _inflate(item_t, v, owner_cls) for k, v in (val or {}).items()}
    import types

    if origin is not None and (origin is types.UnionType
                               or str(origin).endswith("Union")):
        # Optional[...] and PEP 604 "X | None" both land here
        inner = [a for a in get_args(hint) if a is not type(None)]
        if len(inner) == 1:
            return _inflate(inner[0], val, owner_cls)
        return val
    if hint is np.ndarray or hint == "np.ndarray":
        return np.asarray(val, dtype=np.float64)
    if hint is bytes:
        import base64

        return base64.b64decode(val) if isinstance(val, str) else val
    if dataclasses.is_dataclass(hint):
        return from_dict(hint, val)
    return val
