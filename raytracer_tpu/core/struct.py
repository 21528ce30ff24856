"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers the class with `jax.tree_util.register_dataclass`:
fields declared with `field(pytree_node=False)` are static metadata (they
take part in jit specialisation and must be hashable), every other field is
a child node. Instances are immutable; `.replace(**changes)` returns a copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field that marks static (pytree_node=False) fields."""
    return dataclasses.field(metadata={'pytree_node': pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get('pytree_node', True)]
    meta = [f.name for f in fields if not f.metadata.get('pytree_node', True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
