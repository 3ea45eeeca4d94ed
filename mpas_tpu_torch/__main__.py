"""Command-line model driver (port of mpas_tpu/__main__.py).

ref: src/driver/mpas.F + the -n/-s flags of mpas_subdriver.F:110-141.

    python -m mpas_tpu_torch <core> [-n namelist] [-s streams.xml]
        [--mesh icos:N|hex:NX,NY,DC|channel:NX,NY,DC|varres:N[,RATIO]]
        [--duration D_HH:MM:SS] [--dt SECONDS] [--run-dir DIR]
        [--x64] [--cpu]

Cores: sw (shallow water), atmosphere (nonhydrostatic; JW by default),
ocean (baroclinic channel), test (the framework self-test).

The run is on cuda:0 unless --cpu is given; without a CUDA device and
without --cpu it exits nonzero and never falls back to the CPU. --x64 runs
in float64 on the chosen device (the JAX package's flag also forces the
CPU, as a TPU has no float64); the default is float32. Meshes built for
icos: and varres: specs are cached in $MPAS_TPU_TORCH_CACHE (default
~/.cache/mpas_tpu_torch).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mpas_tpu_torch")
    ap.add_argument("core", choices=["sw", "atmosphere", "ocean", "test"])
    ap.add_argument("-n", "--namelist", default=None,
                    help="Fortran-namelist-format config file")
    ap.add_argument("-s", "--streams", default=None,
                    help="streams.<core> XML file")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec (icos:N | hex:NX,NY,DC | "
                         "channel:NX,NY,DC | varres:N[,RATIO])")
    ap.add_argument("--duration", default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--run-dir", default=".")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 on the chosen device")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of cuda:0")
    args = ap.parse_args(argv)

    from mpas_tpu_torch.containers import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"mpas_tpu_torch: {e} (on the command line: --cpu)",
              file=sys.stderr)
        return 1
    dtype = torch.float64 if args.x64 else torch.float32

    if args.core == "test":
        # framework self-test core (ref: core_test, mpas_test_core.F:86-171)
        from mpas_tpu_torch.cores.test_core.core import run_all
        results = run_all(device, dtype)
        return 0 if all(ok for ok, _ in results.values()) else 1

    from mpas_tpu_torch.framework.driver import Driver
    from mpas_tpu_torch.framework.namelist import from_namelist_file
    from mpas_tpu_torch.framework.streams import parse_streams_xml

    if args.core == "sw":
        from mpas_tpu_torch.cores.sw.hooks import HOOKS, default_mesh
    elif args.core == "atmosphere":
        from mpas_tpu_torch.cores.atmosphere.hooks import HOOKS, default_mesh
    else:
        from mpas_tpu_torch.cores.ocean.hooks import HOOKS, default_mesh

    if args.namelist:
        cfg = from_namelist_file(HOOKS.config_cls, args.namelist)
    else:
        cfg = HOOKS.config_cls()
    overrides = {}
    if args.duration:
        overrides["config_run_duration"] = args.duration
    if args.dt:
        overrides["config_dt"] = args.dt
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    streams = parse_streams_xml(args.streams) if args.streams else None
    mesh_spec = args.mesh or default_mesh(cfg)

    driver = Driver(HOOKS, cfg, run_dir=args.run_dir, streams=streams,
                    mesh_spec=mesh_spec, device=device, dtype=dtype)
    driver.init().run().finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
