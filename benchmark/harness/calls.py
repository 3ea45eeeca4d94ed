"""The K2 contractions of the sampled step, kept as the program computed
them, and their comparison with a float64 einsum of the same inputs."""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def recording(sites, calls):
    """While open, every call of the functions at `sites` ((module, name)
    pairs) appends copies of (w, x, out) to `calls`."""
    saved = []

    def wrap(fn):
        def call(w, x):
            out = fn(w, x)
            calls.append((w.clone(), x.clone(), out.clone()))
            return out
        return call
    try:
        for module_name, name in sites:
            mod = importlib.import_module(module_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(getattr(mod, name)))
        yield calls
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def k2_gap(calls):
    """Worst over the calls of max |out - ref| / max |ref|, ref the
    float64 einsum cpi,cik->cpk of the same w and x."""
    if not calls:
        return 1.0
    worst = 0.0
    for w, x, out in calls:
        ref = torch.einsum("cpi,cik->cpk", w.double(), x.double())
        scale = float(ref.abs().max())
        d = float((out.double() - ref).abs().max())
        worst = max(worst, d / scale if scale > 0 else float(d > 0))
    return worst
