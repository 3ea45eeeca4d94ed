"""Spans set from the benchmark's own files around the port's functions,
as chip_smoke.py:kernel_census sets them: for the traced window only, a
function is replaced by a wrapper that runs it inside a torch.profiler
record_function, and put back afterwards."""

from __future__ import annotations

import contextlib
import functools
import importlib


def _resolve(module_name, attr):
    """(owner, name) of a dotted attribute of a module: a function of the
    module, or a method of one of its classes."""
    owner = importlib.import_module(module_name)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


@contextlib.contextmanager
def spanned(specs):
    """specs: (module name, dotted attribute, label) triples; label is a
    span name, or a function of the call's arguments that returns one."""
    from torch.profiler import record_function
    saved = []

    def wrap(fn, label):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            name = label(*args, **kwargs) if callable(label) else label
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    try:
        for module_name, attr, label in specs:
            owner, name = _resolve(module_name, attr)
            fn = owner.__dict__[name] if isinstance(owner, type) \
                else getattr(owner, name)
            saved.append((owner, name, fn))
            setattr(owner, name, wrap(fn, label))
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
