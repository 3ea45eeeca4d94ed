"""The readings that the limits of `correct` are set from, in one process
on the card: each compared number of the program on many seeds, and of
the control (the plain reference put in the program's place, in the
nearest precision below the configuration's) on a few, each over a short
timed window at the cell's own size.

    python3 benchmark/limits.py --workload jw_120km.l26 \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 [--out F]

Prints one JSON line per run and, last, per number the largest program
reading and the smallest control reading. The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common, window  # noqa: E402


def readings(workload, seeds, control_seeds, seconds, device):
    import torch
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "workload")
    config = common.find(spec["configs"], cell["config"], "configuration")
    params = common.config_params(config)
    traffic = common.traffic_params(cell["config"], cell["traffic"])
    mod = common.config_module(cell["config"])
    ref_host = mod.host_init(mod.reference_impl(), params, traffic)
    prog_host = mod.host_init(mod.program_impl(), params, traffic)
    out = []
    for control, seed_list in ((False, seeds), (True, control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            case = mod.build(params, traffic, seed, device, control=control,
                             host=ref_host if control else prog_host)
            steps, window_s, _, rec = window.timed_window(case, seconds,
                                                          seed)
            finite, inputs = case.finite(), case.inputs
            case.release()
            del case
            gc.collect()
            torch.cuda.empty_cache()
            values = mod.check(params, traffic, inputs, rec, device,
                               host=ref_host)
            row = {"side": "control" if control else "program",
                   "seed": seed, "steps": steps, "finite": finite,
                   "sample_at": rec.sample_at, "values": values,
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            out.append(row)
    names = out[0]["values"]
    summary = {n: {"program_max": max((r["values"][n] for r in out
                                       if r["side"] == "program"),
                                      default=None),
                   "control_min": min((r["values"][n] for r in out
                                       if r["side"] == "control"),
                                      default=None)}
               for n in names}
    return out, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    common.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3

    def ints(s):
        return [int(v) for v in s.split(",") if v]
    rows, summary = readings(args.workload, ints(args.seeds),
                             ints(args.control_seeds), args.seconds,
                             torch.device("cuda:0"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": rows,
                                              "summary": summary}))
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
