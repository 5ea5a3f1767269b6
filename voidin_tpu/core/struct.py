"""Frozen dataclasses registered as JAX pytrees.

`dataclass` registers every field as a pytree child in declaration order,
except fields declared with `field(pytree_node=False)`, which become static
(hashable) tree metadata. Instances are immutable; `.replace(**changes)`
returns a copy. io/snapshot.py relies on this leaf order.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field; `pytree_node=False` makes the field static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


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
                     if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = _replace
    return cls
