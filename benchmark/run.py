"""The benchmark of mpas_tpu_torch on NVIDIA H100s.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names its configuration, whose code is benchmark/configs/<config>.py,
and its traffic, benchmark/workloads/<config>/<traffic>.json. Set-up
builds the program's state from inputs drawn from the seed and warms
every shape the window uses. With --trace 0 the timed window runs the
steps in a closed loop for --seconds and gives the end-to-end metrics;
with --trace 1 a traced window of the traffic's trace_steps steps gives
the per-layer metrics (benchmark/metrics/<name>.py). Either way the
program's state is then freed and its outputs are held to the plain
reference (benchmark/reference), each compared number beside its limit.

The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
checks. It exits nonzero with no result without CUDA, with fewer cards
than the cell asks for, or where the process holds the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg):
    print(msg, file=sys.stderr)
    return 3


def verdict(values, limits, finite):
    """(correct, {name: {value, limit}}): every number that the traffic
    gives a limit at or under it, and the final state finite."""
    checks = {}
    ok = finite
    for name, limit in limits.items():
        value = values.get(name)
        if value is not None and not math.isfinite(value):
            value = None            # JSON has no NaN: a missing number
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    checks["final_state_finite"] = {"value": 1 if finite else 0,
                                    "limit": 1}
    return ok, checks


def per_layer(spec, workload, ctx):
    out = {}
    for m in common.metrics_of(spec, workload, "per_layer"):
        v = common.metric_module(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(spec, workload, seed, seconds, trace, device,
             params=None, traffic=None):
    """The result of one run of a cell on `device` (a dict, `checks`
    last). params, traffic: the configuration's and the traffic's
    numbers where given, else their files' (tests run small ones on the
    CPU)."""
    import torch

    from benchmark.harness import window
    cell = common.find(spec["workloads"], workload, "workload")
    config = common.find(spec["configs"], cell["config"], "configuration")
    params = params or common.config_params(config)
    traffic = traffic or common.traffic_params(cell["config"],
                                               cell["traffic"])
    mod = common.config_module(cell["config"])
    cuda = device.type == "cuda"

    case = mod.build(params, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    print(f"setup parts (s): {json.dumps(case.setup_parts)}",
          file=sys.stderr)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"]}
    if trace:
        specs = [s for m in common.metrics_of(spec, workload, "per_layer")
                 for s in common.metric_module(m["name"]).SPANS]
        path = common.CACHE_DIR / "trace" / "window.json"
        steps = traffic["trace_steps"]
        rec = window.traced_window(case, steps, seed, specs, path)
    else:
        steps, window_s, step_ms, rec = window.timed_window(case, seconds,
                                                            seed)
    dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if cuda else 0
    finite, dt, inputs = case.finite(), case.dt, case.inputs
    case.release()
    del case
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = common.forbidden_loaded(sys.modules)
    if bad:
        raise common.ForbiddenModules(
            f"the run holds the JAX package or JAX: {bad}")

    result = {"correct": False, "attempted": steps,
              "failed": 0 if finite else steps}
    if trace:
        from benchmark.harness.trace import Trace
        tr = Trace.load(path)
        ctx = SimpleNamespace(trace=tr, steps=steps, params=params,
                              traffic=traffic,
                              bytes_per_step=mod.bytes_per_step(params,
                                                                traffic))
        result["metrics"] = per_layer(spec, workload, ctx)
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["device"] = dev
        result["breakdown"] = tr.breakdown()
    else:
        from benchmark.harness.stats import percentile, sim_days_per_day
        values = {"sim_days_per_day": sim_days_per_day(steps, dt, window_s),
                  "step_p90_ms": percentile(step_ms, 90.0),
                  "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in common.metrics_of(spec, workload, "end_to_end")}
        result["device"] = dev
    values = mod.check(params, traffic, inputs, rec, device)
    result["correct"], result["checks"] = verdict(values, traffic["limits"],
                                                  finite)
    return result


def main(argv=None):
    args = parse(argv)
    common.set_cache_env()
    spec = common.load_spec()
    cell = common.find(spec["workloads"], args.workload, "workload")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} card(s); "
                    f"{torch.cuda.device_count()} present")
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          args.trace, torch.device("cuda:0"))
    except common.ForbiddenModules as e:
        return fail(str(e))
    import resource
    print("host peak RSS (MB): "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
