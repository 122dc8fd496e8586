"""Frozen dataclasses that are JAX pytrees.

``@pytree.dataclass`` makes a frozen dataclass whose fields are pytree
leaves (they flow through ``jit``/``vmap`` as traced arrays), except fields
declared with :func:`static_field`, which become hashable metadata: part of
the treedef, so a change of value retraces instead of being traced.
Instances get a ``replace(**changes)`` method like ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves (compile-time
    metadata such as shapes or modes)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered with ``jax.tree_util`` (see module doc)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if f.name not in meta]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
