"""Copies of the port's state containers (dataclasses of tensors), and
their conversion into the reference's classes of the same names."""

from __future__ import annotations

import dataclasses

import torch


def clone(obj):
    """A copy of a dataclass of tensors with every tensor cloned, nested
    dataclasses too."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.clone()
        elif dataclasses.is_dataclass(v):
            changes[f.name] = clone(v)
    return dataclasses.replace(obj, **changes)


def convert(obj, classes, dtype):
    """obj as the class of the same name in `classes`, nested dataclasses
    too, every floating tensor cast to `dtype` (indices kept)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dtype) if v.is_floating_point() else v
        elif dataclasses.is_dataclass(v):
            v = convert(v, classes, dtype)
        kw[f.name] = v
    return classes[type(obj).__name__](**kw)
