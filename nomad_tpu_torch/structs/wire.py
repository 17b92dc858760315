"""Type-tagged codec of the raft log and the snapshots (a trimmed copy of
``nomad_tpu/structs/wire.py``).

A replicated command's arguments can hold any struct, so dataclass
values carry their class name and inflate back through a registry of
every struct dataclass of the port. numpy arrays keep their dtype,
tuples, sets, bytes and dicts with non-string keys keep their type.
The reference's ACL types are not registered (the port has no ACL).

Decoding reads only the fields the port's class has, so a reference
dump whose structs carry more fields (and nested types the port does
not model) decodes into the port's trimmed structs.
"""

from __future__ import annotations

import base64
import dataclasses
from typing import Any, Dict

import numpy as np

_REGISTRY: Dict[str, type] = {}
# per class, the names of its fields that ride (no "_"-prefixed caches)
_FIELD_NAMES: Dict[type, tuple] = {}


def _build_registry() -> None:
    if _REGISTRY:
        return
    from . import (alloc, constraint, deployment, evaluation, job, network,
                   node, operator, plan, resources, services, volumes)

    for mod in (alloc, constraint, deployment, evaluation, job, network,
                node, operator, plan, resources, services, volumes):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                existing = _REGISTRY.get(obj.__name__)
                if existing is not None and existing is not obj:
                    raise RuntimeError(
                        f"wire codec name collision: {obj.__name__}")
                _REGISTRY[obj.__name__] = obj


def wire_encode(obj: Any) -> Any:
    """Lower any command or struct graph to JSON-safe values, with type
    tags where the shape alone cannot recover the Python type."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, np.ndarray):
        return {"__nd": obj.tolist(), "__dt": str(obj.dtype)}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, tuple):
        return {"__tp": [wire_encode(v) for v in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"__set": [wire_encode(v) for v in sorted(obj, key=repr)]}
    if isinstance(obj, list):
        return [wire_encode(v) for v in obj]
    if isinstance(obj, dict):
        if all(isinstance(k, str) and not k.startswith("__") for k in obj):
            return {k: wire_encode(v) for k, v in obj.items()}
        # tuple and other keys ride as pair lists
        return {"__d": [[wire_encode(k), wire_encode(v)]
                        for k, v in obj.items()]}
    cls = type(obj)
    names = _FIELD_NAMES.get(cls)
    if names is None and dataclasses.is_dataclass(obj) \
            and not isinstance(obj, type):
        _build_registry()
        if cls.__name__ not in _REGISTRY:
            raise TypeError(f"unregistered wire type {cls.__name__}")
        # "_"-prefixed fields are derived caches (Node._avail_vec,
        # AllocBlock._offsets); they never ride, decode takes the default
        names = _FIELD_NAMES[cls] = tuple(
            f.name for f in dataclasses.fields(obj)
            if not f.name.startswith("_"))
    if names is not None:
        return {"__t": cls.__name__,
                "__f": {n: wire_encode(getattr(obj, n)) for n in names}}
    raise TypeError(f"cannot wire-encode {type(obj).__name__}")


def wire_decode(data: Any) -> Any:
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [wire_decode(v) for v in data]
    if isinstance(data, dict):
        if "__b" in data and len(data) == 1:
            return base64.b64decode(data["__b"])
        if "__nd" in data:
            return np.asarray(data["__nd"], dtype=data.get("__dt", "float64"))
        if "__tp" in data and len(data) == 1:
            return tuple(wire_decode(v) for v in data["__tp"])
        if "__set" in data and len(data) == 1:
            return set(wire_decode(v) for v in data["__set"])
        if "__d" in data and len(data) == 1:
            return {wire_decode(k): wire_decode(v) for k, v in data["__d"]}
        if "__t" in data:
            _build_registry()
            cls = _REGISTRY.get(data["__t"])
            if cls is None:
                raise TypeError(f"unknown wire type {data['__t']}")
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: wire_decode(v) for k, v in data["__f"].items()
                          if k in known})
        return {k: wire_decode(v) for k, v in data.items()}
    raise TypeError(f"cannot wire-decode {type(data).__name__}")
