"""Spans and hierarchical named timers (port of
mpas_tpu/framework/timers.py).

span(name) is the one way the program marks a region of its work
(spanned(name) decorates a function whose whole body is the region). While
a torch.profiler session is active it opens a record_function of that
name, a user annotation in the profiler's own timeline, to which the
profiler aligns the device activity the region launches; otherwise it
returns one shared null context and calls no torch op, so a marked step
costs well under a microsecond a span when nobody profiles.

ref: src/framework/mpas_timer.F: nested named timers :88-243, aggregated
table at finalize :365-485. TimerManager.timer(name) opens span(name),
takes the host clock at both ends and, on a CUDA device, records a pair
of timing events on the device's stream. Nothing waits for the device
inside a run: a timer's pairs whose end has completed are resolved each
time it closes, and table() synchronises once to resolve the rest.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager, nullcontext

import torch

_OFF = nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager marking the region `name`: a
    torch.profiler.record_function inside a profiler session, a shared
    null context outside one."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator making each call of a function the region `name`,
    for spans that cover a whole function body."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class TimerNode:
    __slots__ = ("name", "count", "host", "device", "pending", "children")

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.host = 0.0             # seconds on the host clock
        self.device = 0.0           # seconds between resolved event pairs
        self.pending = []           # (start, end) events not yet resolved
        self.children: dict[str, TimerNode] = {}

    def resolve(self):
        """Add the device time of every leading pair whose end event has
        completed (a stream completes its events in order)."""
        while self.pending and self.pending[0][1].query():
            start, end = self.pending.pop(0)
            self.device += 1e-3 * start.elapsed_time(end)


class TimerManager:
    """device: where the timed work runs; on a CUDA device each timer
    also keeps the device time between its ends."""

    def __init__(self, device=None):
        self.root = TimerNode("total")
        self._stack = [self.root]
        self.device = None if device is None else torch.device(device)
        self._cuda = self.device is not None and self.device.type == "cuda"

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    @contextmanager
    def timer(self, name: str):
        parent = self._stack[-1]
        node = parent.children.setdefault(name, TimerNode(name))
        self._stack.append(node)
        start = self._event() if self._cuda else None
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            node.host += time.perf_counter() - t0
            node.count += 1
            if start is not None:
                node.pending.append((start, self._event()))
                node.resolve()
            self._stack.pop()

    def table(self) -> str:
        """Render the tree like the reference's finalize table
        (ref: mpas_timer_write): calls, host seconds and, on a CUDA
        device, device seconds of each timer."""
        if self._cuda:
            torch.cuda.synchronize(self.device)
        lines = [f"{'timer name':<40s} {'calls':>7s} {'host (s)':>12s} "
                 f"{'device (s)':>12s}"]

        def rec(node, depth):
            for child in node.children.values():
                child.resolve()
                dev = f"{child.device:>12.4f}" if self._cuda \
                    else f"{'-':>12s}"
                lines.append(f"{'  ' * depth + child.name:<40s} "
                             f"{child.count:>7d} {child.host:>12.4f} {dev}")
                rec(child, depth + 1)

        rec(self.root, 0)
        return "\n".join(lines)
