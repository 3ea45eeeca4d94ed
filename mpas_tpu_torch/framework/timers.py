"""Hierarchical named timers (port of mpas_tpu/framework/timers.py).

ref: src/framework/mpas_timer.F: nested named timers :88-243, aggregated
table at finalize :365-485. Wall clock on the host; a `sync` callable
(torch.cuda.synchronize where the work runs on a card) waits for the
device at both ends of a timer, so that a timer measures the device work
and not only its dispatch — the analogue of the reference's MPI-barrier'd
timers.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class TimerNode:
    __slots__ = ("name", "total", "count", "children", "_start")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: dict[str, TimerNode] = {}
        self._start = None


class TimerManager:
    def __init__(self, sync=None):
        self.root = TimerNode("total")
        self._stack = [self.root]
        self.sync = sync

    @contextmanager
    def timer(self, name: str):
        parent = self._stack[-1]
        node = parent.children.setdefault(name, TimerNode(name))
        if self.sync:
            self.sync()
        t0 = time.perf_counter()
        self._stack.append(node)
        try:
            yield
        finally:
            if self.sync:
                self.sync()
            node.total += time.perf_counter() - t0
            node.count += 1
            self._stack.pop()

    def start(self, name: str):
        parent = self._stack[-1]
        node = parent.children.setdefault(name, TimerNode(name))
        node._start = time.perf_counter()
        self._stack.append(node)

    def stop(self, name: str):
        node = self._stack[-1]
        if node.name != name:
            raise RuntimeError(f"timer_stop({name}) but {node.name} is open")
        node.total += time.perf_counter() - node._start
        node.count += 1
        self._stack.pop()

    def table(self) -> str:
        """Render the tree like the reference's finalize table
        (ref: mpas_timer_write)."""
        lines = [f"{'timer name':<40s} {'calls':>7s} {'total (s)':>12s} "
                 f"{'avg (ms)':>10s}"]

        def rec(node, depth):
            for child in node.children.values():
                avg = child.total / max(child.count, 1) * 1e3
                lines.append(f"{'  ' * depth + child.name:<40s} "
                             f"{child.count:>7d} {child.total:>12.4f} "
                             f"{avg:>10.3f}")
                rec(child, depth + 1)

        rec(self.root, 0)
        return "\n".join(lines)
