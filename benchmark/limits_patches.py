"""The readings that the limits of `correct` are set from for a cell
checked on patches of its mesh (jw_15km), in one process on one card:
benchmark/limits.py's rule (each compared number of the program on many
seeds, of the control on a few), each reading the configuration's
readings(params, traffic, seed, device, program) on the seed's patches.
The program's readings run its one-card path on the patches, whose
row-wise arithmetic is that of the cell's shards, so a globe that needs
several cards is read on one.

    python3 benchmark/limits_patches.py --workload jw_15km.4chip \
        --seeds 11,12,13 --control-seeds 21,22,23 [--out F]

Prints one JSON line per reading and, last, per number the largest
program reading and the smallest control reading. The benchmark's runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402


def readings(workload, seeds, control_seeds, device):
    spec = common.load_spec()
    cell = common.find(spec["workloads"], workload, "workload")
    config = common.find(spec["configs"], cell["config"], "configuration")
    params = common.config_params(config)
    traffic = common.traffic_params(cell["config"], cell["traffic"])
    mod = common.config_module(cell["config"])
    mod.prepare(params, traffic)
    out = []
    for program, seed_list in ((True, seeds), (False, control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            row = {"side": "program" if program else "control",
                   "seed": seed,
                   "values": mod.readings(params, traffic, seed, device,
                                          program),
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
                             ints(args.control_seeds), torch.device("cuda"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": rows,
                                              "summary": summary}))
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
