"""Frozen dataclasses registered as JAX pytrees.

Every field is a pytree leaf (or subtree), in declaration order, so the
containers flow through jit / vmap / scan / shard_map and flatten to the same
leaf list a checkpoint stores.  ``replace`` returns a copy with some fields
changed, like ``dataclasses.replace``.
"""
from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Decorator: ``cls`` as a frozen dataclass whose fields are all data."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = _replace
    return cls
