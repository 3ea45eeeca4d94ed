"""Reduction of one traced window (a torch.profiler chrome trace) to what
the per-layer metrics read: the device operations with the host time of
their launch, the benchmark's spans, the window itself.

Every time is in seconds on the trace's clock. A device operation belongs
to a span when the host call that launched it (the runtime or driver
event of the same correlation id) lies inside the span.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from benchmark.harness.stats import gaps, union_seconds

WINDOW_SPAN = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events):
        launch = {}
        spans = defaultdict(list)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = 1e-6 * float(e["ts"]), 1e-6 * float(e.get("dur", 0.0))
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = ts
            elif cat == "user_annotation":
                spans[e["name"]].append((ts, ts + dur))
            elif cat in DEVICE_CATS:
                device.append((e["name"], ts, ts + dur, cat,
                               e.get("args", {}).get("correlation")))
        n = len(spans.get(WINDOW_SPAN, ()))
        if n != 1:
            raise ValueError(f"the trace holds {n} '{WINDOW_SPAN}' spans, "
                             "not one")
        self.window = spans.pop(WINDOW_SPAN)[0]
        lo, hi = self.window
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        # (name, start, end, is_kernel, launch time) of the window's ops
        self.ops = [(n, s, e, cat == "kernel", launch.get(c))
                    for n, s, e, cat, c in device if e > lo and s < hi]

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return union_seconds([(s, e) for _, s, e, _, _ in self.ops],
                             *self.window)

    def kernel_count(self) -> int:
        return sum(1 for op in self.ops if op[3])

    def _in_span(self, name, t) -> bool:
        starts = self._starts.get(name)
        if t is None or not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and self.spans[name][i][1] >= t

    def device_s_in(self, name) -> float:
        """Device seconds of the operations launched inside span `name`."""
        return sum(e - s for _, s, e, _, t in self.ops
                   if self._in_span(name, t))

    def device_s_by_span(self, prefix):
        """{span name: (launches, device seconds)} of the kernels launched
        inside each span whose name starts with `prefix`."""
        names = [n for n in self.spans if n.startswith(prefix)]
        out = {}
        for _, s, e, is_kernel, t in self.ops:
            if not is_kernel:
                continue
            for n in names:
                if self._in_span(n, t):
                    k, d = out.get(n, (0, 0.0))
                    out[n] = (k + 1, d + (e - s))
        return out

    def innermost_span(self, t) -> str:
        """The innermost of the benchmark's spans open at host time t."""
        best, name = None, "outside the benchmark's spans"
        for n, starts in self._starts.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and self.spans[n][i][1] >= t \
                    and (best is None or starts[i] > best):
                best, name = starts[i], n
        return name

    def breakdown(self, top=10):
        """{"device_ops": the device operations that took most time,
        summed by name; "idle_gaps": the window's idle time, summed by the
        span in which the host launched the operation that ended each
        gap}, each a list of at most `top` [name, seconds]."""
        by_op = defaultdict(float)
        for n, s, e, _, _ in self.ops:
            by_op[n] += e - s
        ops = sorted(self.ops, key=lambda op: op[1])
        starts = [op[1] for op in ops]
        by_gap = defaultdict(float)
        for g0, g1 in gaps([(s, e) for _, s, e, _, _ in ops], *self.window):
            i = bisect.bisect_left(starts, g1)
            label = "end of the window" if i >= len(ops) else (
                "no launch recorded" if ops[i][4] is None
                else self.innermost_span(ops[i][4]))
            by_gap[label] += g1 - g0

        def top_of(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_gap)}
