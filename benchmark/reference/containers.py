# Frozen copy of mpas_tpu_torch/containers.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Device/dtype moves shared by the port's dataclass containers, and the
default device of the entry points that build state."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or cuda:0 where it is None; raises where CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)


def to_host(t):
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


def to_device(obj, device, dtype):
    """Copy of dataclass `obj` with every tensor field on `device`:
    floating tensors cast to `dtype`, integer (index) tensors to int64 —
    torch advanced indexing takes int64, so the cast happens once here
    rather than at every gather. Nested containers move recursively;
    static ints/floats are kept."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            t = dtype if v.is_floating_point() else torch.int64
            changes[f.name] = v.to(device=device, dtype=t)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = v.to(device, dtype)
    return dataclasses.replace(obj, **changes)
