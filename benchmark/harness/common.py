"""Paths, the run's environment and discovery by name: a configuration,
a traffic mix and a per-layer metric are each found from their names in
BENCHMARK.json, so that adding one adds files and entries and edits none.

- configuration <c>: benchmark/configs/<c>.py (its code: inputs from the
  seed, the step, the count of step_mfu, the check) beside the file of
  sizes that BENCHMARK.json names;
- traffic <t> of configuration <c>: benchmark/workloads/<c>/<t>.json;
- per-layer metric <m>: benchmark/metrics/<m>.py, with SPANS (the spans
  it reads) and read(ctx) -> number or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
# whole top-level module names that no run may hold (the JAX package and
# what it loads); compared whole, since the port's name begins with it
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mpas_tpu")


class ForbiddenModules(RuntimeError):
    """The process holds a module that no run may hold."""


def set_cache_env():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("MPAS_TPU_TORCH_CACHE", "mpas_tpu_torch"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_spec(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_module(config_name):
    return _load_module(BENCH_DIR / "configs" / f"{config_name}.py",
                        f"benchmark_config_{config_name}")


def config_params(config_entry, root=ROOT):
    with open(Path(root) / config_entry["file"]) as f:
        return json.load(f)


def traffic_params(config_name, traffic_name):
    with open(BENCH_DIR / "workloads" / config_name
              / f"{traffic_name}.json") as f:
        return json.load(f)


def metric_module(metric_name):
    return _load_module(BENCH_DIR / "metrics" / f"{metric_name}.py",
                        f"benchmark_metric_{metric_name}")


def metrics_of(spec, workload_name, kind):
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in spec[kind]
            if workload_name in m.get("workloads", [workload_name])]


def forbidden_loaded(modules):
    """Names of loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})
