"""A cell on P > 1 cards: P processes, one a card, rank r on cuda:r.

run.py's process, the launcher, makes what the configuration's ranks
read before any of them starts (the configuration's optional
prepare(params, traffic): its mesh file, built once by this one
process), starts the ranks (multiprocessing's spawn) and waits for them.
The ranks join one torch.distributed group, NCCL on the cards and gloo
on the CPU (the tests), through a file under benchmark/.cache/ranks, and
a gloo group for the harness's host barriers and exchanges of numbers.
Each builds its shard with the configuration's
build(params, traffic, seed, device, group=RankGroup).

A rank's case is the one-card case's interface with one call more:
snapshot() copies this rank's shard on its card, and gather(snapshot),
which every rank takes once the window has closed, returns the global
state on rank 0 (None elsewhere); the check reads those.

The windows run in lockstep: rank 0 decides on the host whether to issue
another step and whether it is the sampled one, and each decision
reaches the other ranks through a queue before they issue that step.
The harness adds nothing else inside the window: no collective, no copy
to the host, no wait for the card but the one after its last step (a
step's own halo exchanges are the program's). Every rank records its CUDA events as the one-card
window does; a step's time is its largest interval over the ranks, the
90th percentile is taken over those, and window_s is rank 0's host time
between two host barriers of all ranks: before any rank issues the first
step, and after every rank's card has finished its last. setup_s runs
from the start of the launcher's process to the first barrier. With
--trace 1 every rank profiles the same steps into
trace/window.rank<r>.json; the per-layer metrics read the trace of the
rank with the most busy time, the one that sets the pace (ctx.trace;
every rank's in ctx.traces), with bytes_per_step each card's share of
the configuration's count.

Then every rank reads its peak memory, releases its state, gathers the
three snapshots to rank 0 through its case and hands its numbers to
rank 0 (steps, the sampled step, step times, peak memory, finite): the
step counts and sampled steps have to agree, memory_peak_bytes is the
fullest card's, finite holds where it holds on every rank. Rank 0 alone
runs the configuration's check, on the global snapshots, and hands the
result to the launcher, which alone prints it. What a rank prints goes
to standard error. A rank that fails, dies or outlasts the time limits
ends the run nonzero with no result, and the launcher ends the other
ranks.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import json
import multiprocessing
import os
import queue as queue_mod
import resource
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

from benchmark.harness import common

STOP, STEP, SAMPLE = 0, 1, 2
GROUP_TIMEOUT_S = 600.0     # a collective, or a wait for rank 0's decision
WAIT_S = 1150.0             # the ranks' whole run: set-up, window, check
STORE_DIR = common.CACHE_DIR / "ranks"


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """What a configuration's build gets where the cell has P > 1 cards:
    this rank, the number of ranks (the default torch.distributed group
    of `size` ranks is initialised), and the gloo group of the harness's
    host barriers, for a case's exchanges on the host after the window."""
    rank: int
    size: int
    host: object = dataclasses.field(default=None, compare=False)


class RankFailure(RuntimeError):
    """A rank failed, died, or the ranks outlasted the time limit."""


class _Lead:
    """Rank 0: each decision goes to the other ranks as it is made."""

    def __init__(self, queues):
        self.queues = queues

    def decide(self, decision):
        for q in self.queues:
            q.put(decision)
        return decision


class _Follow:
    """Rank r > 0: takes rank 0's decision, whatever its own would be."""

    def __init__(self, q, timeout):
        self.q, self.timeout = q, timeout

    def decide(self, _):
        try:
            return self.q.get(timeout=self.timeout)
        except queue_mod.Empty:
            raise RankFailure(f"no decision from rank 0 in {self.timeout} "
                              "s") from None


def _sample_after(case, rec, n, lock):
    """Steps after the window until the sampled step is taken, untimed
    (rank 0's snapshots decide)."""
    from benchmark.harness import window
    while True:
        d = lock.decide(STOP if rec.pre is not None else
                        SAMPLE if case.checkable() else STEP)
        if d == STOP:
            return
        window._step(case, rec, n, d == SAMPLE)
        n += 1


def timed_window(case, seconds, seed, lock, host, t_start):
    """(steps, window seconds, this rank's step ms, Record, setup_s) of
    the closed loop in lockstep (module docstring)."""
    import torch.distributed as dist

    from benchmark.harness import window
    rec = window.Record()
    target = window.sample_fraction(seed) * seconds
    window._sync(case.device)
    dist.barrier(group=host)
    marks = window._Events() if case.device.type == "cuda" \
        else window._HostMarks()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n = 0
    while True:
        now = time.perf_counter() - t0
        d = lock.decide(
            STOP if n >= window.START_STEPS and now >= seconds else
            SAMPLE if rec.pre is None and n >= window.START_STEPS
            and now >= target and case.checkable() else STEP)
        if d == STOP:
            break
        window._step(case, rec, n, d == SAMPLE)
        marks.mark()
        n += 1
    window._sync(case.device)
    dist.barrier(group=host)
    window_s = time.perf_counter() - t0
    step_ms = marks.step_ms()
    _sample_after(case, rec, n, lock)
    return len(step_ms), window_s, step_ms, rec, setup_s


def traced_window(case, steps, seed, specs, path, lock, host):
    """The Record of `steps` steps under this rank's torch.profiler, as
    window.traced_window runs them, in lockstep."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import window
    from benchmark.harness.spans import spanned
    from benchmark.harness.trace import WINDOW_SPAN
    if steps <= window.START_STEPS:
        raise ValueError(f"a traced window needs more than "
                         f"{window.START_STEPS} steps")
    rec = window.Record()
    first = window.START_STEPS + int(window.sample_fraction(seed)
                                     * (steps - window.START_STEPS))
    activities = [ProfilerActivity.CPU]
    if case.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    window._sync(case.device)
    dist.barrier(group=host)
    with spanned(specs), profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            for n in range(steps):
                d = lock.decide(SAMPLE if rec.pre is None and n >= first
                                and case.checkable() else STEP)
                with record_function("step"):
                    window._step(case, rec, n, d == SAMPLE)
            window._sync(case.device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    _sample_after(case, rec, steps, lock)
    return rec


def trace_path(rank):
    return common.CACHE_DIR / "trace" / f"window.rank{rank}.json"


def combine(numbers):
    """The ranks' numbers (one dict a rank) as one run's: the step count
    and the sampled step, which have to agree; each step's largest time;
    the fullest card's peak; finite where every rank is."""
    for key in ("steps", "start_at", "sample_at"):
        seen = [r[key] for r in numbers]
        if len(set(seen)) != 1:
            raise RankFailure(f"the ranks disagree on {key}: {seen}")
    memory = [r["memory"] for r in numbers]
    return {"steps": numbers[0]["steps"],
            "step_ms": [max(t) for t in zip(*(r["step_ms"]
                                              for r in numbers))],
            "memory_peak_bytes": max(memory),
            "memory_peak_bytes_by_rank": memory,
            "finite": all(r["finite"] for r in numbers)}


def pacing_rank(busy):
    """The rank whose card was busy longest (the first of a tie): the one
    that sets the pace of a run in lockstep."""
    return max(range(len(busy)), key=busy.__getitem__)


def _peak_bytes(device):
    import torch
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _rank_run(job, rank, device, host, lock):
    """This rank's part up to the exchange of numbers: build, window,
    release. Returns (its numbers, what rank 0 needs after)."""
    import torch
    import torch.distributed as dist
    mod = common._load_module(Path(job.config_file),
                              f"benchmark_ranks_{Path(job.config_file).stem}")
    case = mod.build(job.params, job.traffic, job.seed, device,
                     group=RankGroup(rank, job.world, host))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"rank {rank} setup parts (s): {json.dumps(case.setup_parts)}",
          file=sys.stderr)
    setup_s = window_s = None
    if job.trace:
        specs = [s for m in common.metrics_of(job.spec, job.workload,
                                              "per_layer")
                 for s in common.metric_module(m["name"]).SPANS]
        steps, step_ms = job.traffic["trace_steps"], []
        rec = traced_window(case, steps, job.seed, specs, trace_path(rank),
                            lock, host)
    else:
        steps, window_s, step_ms, rec, setup_s = timed_window(
            case, job.seconds, job.seed, lock, host, job.t_start)
    mine = {"steps": steps, "start_at": rec.start_at,
            "sample_at": rec.sample_at, "step_ms": step_ms,
            "memory": _peak_bytes(device), "finite": case.finite()}
    dt, inputs = case.dt, case.inputs
    case.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec.start, rec.pre, rec.post = (case.gather(s) for s in
                                    (rec.start, rec.pre, rec.post))
    del case
    bad = common.forbidden_loaded(sys.modules)
    if bad:
        raise common.ForbiddenModules(
            f"rank {rank} holds the JAX package or JAX: {bad}")
    numbers = [None] * job.world
    dist.all_gather_object(numbers, mine, group=host)
    print(f"rank {rank} host peak RSS (MB): "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}",
          file=sys.stderr)
    return numbers, SimpleNamespace(mod=mod, rec=rec, dt=dt, inputs=inputs,
                                    window_s=window_s, setup_s=setup_s)


def _result(job, device, numbers, kept):
    """Rank 0: the run's result (run.py's keys, `checks` last)."""
    import torch

    from benchmark.run import per_layer, verdict
    run = combine(numbers)
    cuda = device.type == "cuda"
    steps, finite = run["steps"], run["finite"]
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": job.world,
           "memory_peak_bytes": run["memory_peak_bytes"],
           "memory_peak_bytes_by_rank": run["memory_peak_bytes_by_rank"]}
    result = {"correct": False, "attempted": steps,
              "failed": 0 if finite else steps}
    if job.trace:
        from benchmark.harness.trace import Trace
        traces = [Trace.load(trace_path(r)) for r in range(job.world)]
        busy = [t.busy_s() for t in traces]
        pace = pacing_rank(busy)
        ctx = SimpleNamespace(
            trace=traces[pace], traces=traces, steps=steps,
            params=job.params, traffic=job.traffic,
            bytes_per_step=kept.mod.bytes_per_step(job.params, job.traffic)
            / job.world)
        result["metrics"] = per_layer(job.spec, job.workload, ctx)
        dev["busy_s"], dev["window_s"] = busy[pace], traces[pace].window_s
        dev["trace_rank"] = pace
        result["device"] = dev
        result["breakdown"] = traces[pace].breakdown()
    else:
        from benchmark.harness.stats import percentile, sim_days_per_day
        values = {"sim_days_per_day": sim_days_per_day(steps, kept.dt,
                                                       kept.window_s),
                  "step_p90_ms": percentile(run["step_ms"], 90.0),
                  "setup_s": kept.setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in common.metrics_of(job.spec, job.workload, "end_to_end")}
        result["device"] = dev
    values = kept.mod.check(job.params, job.traffic, kept.inputs, kept.rec,
                            device)
    result["correct"], result["checks"] = verdict(values,
                                                  job.traffic["limits"],
                                                  finite)
    return result


def _rank_main(rank, job, orders, results):
    """Body of one rank's process: it exits 0 having done its part (rank 0
    having handed over the result), else prints why and exits 1 at once."""
    os.dup2(2, 1)                  # what a rank prints goes to stderr
    sys.stdout = sys.stderr
    try:
        import torch
        import torch.distributed as dist
        cuda = job.backend == "nccl"
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)     # the ranks share the host's cores
        timeout = datetime.timedelta(seconds=job.group_timeout_s)
        dist.init_process_group(job.backend, init_method=f"file://{job.store}",
                                world_size=job.world, rank=rank,
                                timeout=timeout)
        host = dist.new_group(backend="gloo", timeout=timeout) if cuda \
            else dist.group.WORLD
        if cuda:
            dist.barrier()               # every rank joins the NCCL group
        lock = _Lead(orders) if rank == 0 else _Follow(orders[rank - 1],
                                                       job.group_timeout_s)
        numbers, kept = _rank_run(job, rank, device, host, lock)
        dist.destroy_process_group()
        if rank == 0:
            results.put((_result(job, device, numbers, kept), numbers))
            results.close()
            results.join_thread()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def run_ranks(spec, workload, seed, seconds, trace, t_start, *,
              backend="nccl", params=None, traffic=None, config_file=None,
              group_timeout_s=GROUP_TIMEOUT_S):
    """(rank 0's result, every rank's numbers) of one run of `workload`
    over its `chips` ranks. params, traffic: the configuration's and the
    traffic's numbers where given, else their files'; config_file: the
    configuration's code where given, else benchmark/configs/<config>.py
    (tests give their own). Raises RankFailure where a rank fails."""
    cell = common.find(spec["workloads"], workload, "workload")
    config = common.find(spec["configs"], cell["config"], "configuration")
    params = params or common.config_params(config)
    traffic = traffic or common.traffic_params(cell["config"],
                                               cell["traffic"])
    config_file = str(config_file or common.BENCH_DIR / "configs"
                      / f"{cell['config']}.py")
    mod = common._load_module(Path(config_file),
                              f"benchmark_ranks_{Path(config_file).stem}")
    if hasattr(mod, "prepare"):
        mod.prepare(params, traffic)
    world = cell["chips"]
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    store = STORE_DIR / f"store.{os.getpid()}"
    store.unlink(missing_ok=True)
    job = SimpleNamespace(
        spec=spec, workload=workload, seed=seed, seconds=seconds,
        trace=trace, t_start=t_start, params=params, traffic=traffic,
        config_file=config_file, world=world, backend=backend,
        store=str(store), group_timeout_s=group_timeout_s)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    orders = [ctx.Queue() for _ in range(world - 1)]
    procs = [ctx.Process(target=_rank_main, args=(r, job, orders, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    try:
        return _wait(procs, results, WAIT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join()
        store.unlink(missing_ok=True)


def _wait(procs, results, wait_s):
    """Rank 0's (result, numbers) once every rank has exited 0."""
    end = time.monotonic() + wait_s
    got = None
    while True:
        if got is None:
            try:
                got = results.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        else:
            time.sleep(0.1)
        codes = [p.exitcode for p in procs]
        failed = {r: c for r, c in enumerate(codes) if c not in (None, 0)}
        if failed:
            raise RankFailure(f"rank(s) failed, exit codes {failed}")
        if all(c == 0 for c in codes):
            if got is None:
                try:
                    got = results.get(timeout=1.0)
                except queue_mod.Empty:
                    raise RankFailure("rank 0 exited without a result") \
                        from None
            return got
        if time.monotonic() > end:
            raise RankFailure(f"the ranks did not finish within {wait_s} s")


def main(spec, args, t_start, **kw):
    """run.py's main for a cell on P > 1 cards: 0 with the result as the
    last line of standard output, else nonzero with none."""
    try:
        result, _ = run_ranks(spec, args.workload, args.seed, args.seconds,
                              args.trace, t_start, **kw)
    except (RankFailure, common.ForbiddenModules) as e:
        print(e, file=sys.stderr)
        return 3
    bad = common.forbidden_loaded(sys.modules)
    if bad:
        print(f"the launcher holds the JAX package or JAX: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
