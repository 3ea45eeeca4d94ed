"""The measured windows.

The timed window runs the cell's steps in a closed loop (each step issued
once the previous one is issued) for `seconds` of host time, then waits
for the card. A CUDA event recorded after each step's work is enqueued
gives each step's time as the interval between two events, read after
the window; nothing synchronises inside it. The traced window runs a
fixed number of steps under torch.profiler, with the spans of the
metrics the cell reports.

Both windows keep what the check compares: the program's state after
START_STEPS steps of the window, and before and after one step sampled
at a time drawn from the seed, with that step's K2 contractions.
"""

from __future__ import annotations

import random
import time
from pathlib import Path

import torch

from benchmark.harness.calls import recording
from benchmark.harness.spans import spanned
from benchmark.harness.trace import WINDOW_SPAN

START_STEPS = 3


class Record:
    """What the check reads: snapshots of the program's state, each with
    the number of steps made from the initial state when it was taken."""

    def __init__(self):
        self.start = self.pre = self.post = None
        self.start_at = self.sample_at = None
        self.k2_calls = []      # (w, x, out) of the sampled step's K2


def sample_fraction(seed: int) -> float:
    """Where in the window the sampled step lies, as a share of it."""
    return random.Random(seed).uniform(0.1, 0.8)


class _Events:
    """Step times from CUDA events (the card's clock)."""

    def __init__(self):
        self.first = torch.cuda.Event(enable_timing=True)
        self.first.record()
        self.events = []

    def mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)

    def step_ms(self):
        out, prev = [], self.first
        for e in self.events:
            out.append(prev.elapsed_time(e))
            prev = e
        return out


class _HostMarks:
    """Step times from the host clock, for runs on the CPU (tests)."""

    def __init__(self):
        self.times = [time.perf_counter()]

    def mark(self):
        self.times.append(time.perf_counter())

    def step_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.times, self.times[1:])]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(case, rec, n, sample_now):
    if sample_now:
        rec.pre, rec.sample_at = case.snapshot(), case.steps_done
        with recording(case.k2_sites, rec.k2_calls):
            case.step()
        rec.post = case.snapshot()
    else:
        case.step()
    if n + 1 == START_STEPS:
        rec.start, rec.start_at = case.snapshot(), case.steps_done


def timed_window(case, seconds: float, seed: int):
    """(steps, window seconds, each step's ms, Record)."""
    rec = Record()
    target = sample_fraction(seed) * seconds
    _sync(case.device)
    marks = _Events() if case.device.type == "cuda" else _HostMarks()
    t0 = time.perf_counter()
    n = 0
    while n < START_STEPS or time.perf_counter() - t0 < seconds:
        now = time.perf_counter() - t0
        _step(case, rec, n, rec.pre is None and n >= START_STEPS
              and now >= target and case.checkable())
        marks.mark()
        n += 1
    _sync(case.device)
    window_s = time.perf_counter() - t0
    step_ms = marks.step_ms()
    while rec.pre is None:          # the sample after the window, untimed
        _step(case, rec, n, case.checkable())
        n += 1
    return len(step_ms), window_s, step_ms, rec


def traced_window(case, steps: int, seed: int, specs, trace_path: Path):
    """(Record, path of the chrome trace) of `steps` steps under
    torch.profiler with the spans `specs`; the sampled step lies at the
    seed's share of the steps after the first START_STEPS."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if steps <= START_STEPS:
        raise ValueError(f"a traced window needs more than {START_STEPS} "
                         "steps")
    rec = Record()
    first = START_STEPS + int(sample_fraction(seed)
                              * (steps - START_STEPS))
    activities = [ProfilerActivity.CPU]
    if case.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(case.device)
    with spanned(specs), profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            for n in range(steps):
                with record_function("step"):
                    _step(case, rec, n, rec.pre is None and n >= first
                          and case.checkable())
            _sync(case.device)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    n = steps
    while rec.pre is None:
        _step(case, rec, n, case.checkable())
        n += 1
    return rec
