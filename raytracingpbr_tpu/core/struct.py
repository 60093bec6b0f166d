"""Frozen dataclasses that are JAX pytrees (``@dataclass``, ``field``).

Fields are pytree leaves unless declared ``field(pytree_node=False)``, which
makes them static metadata (hashable, part of the jit cache key). Instances
are immutable; ``obj.replace(**changes)`` returns a copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls
