"""Frozen pytree dataclasses with static (non-traced) fields.

``@dataclass`` makes a frozen dataclass and registers it as a JAX pytree
node: every field is a traced child unless declared with
``field(pytree_node=False)``, in which case it is hashable static aux data
(changing it re-traces, never reaches the device). ``.replace(**kw)`` is
the functional update.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static aux data."""
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree node (see module doc)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **updates: dataclasses.replace(self, **updates)
    return cls
