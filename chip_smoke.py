#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mpas_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which asserts:

1. versions, and the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from mpas_tpu_torch/csrc;
3. each kernel against its plain PyTorch version at the main path's
   shapes, in float64 and float32, with kernel and plain times;
4. a small float64 JW trajectory (642 cells, 10 levels, 24 steps) on the
   card against the same run on the CPU, and the worst err/tol ratio
   against tests/golden/jw_case2.npz (printed only);
5. the main path: JW baroclinic wave on the 40,962-cell icosahedral mesh
   with 26 levels in float32 (setup, then timed steps), with finite
   fields, conserved dry mass and launch counts that prove every step
   went through both kernels.

The second-to-last line is a JSON object with each kernel's numbers, the
last one {"ok": true, "device": {...}}. Without CUDA it fails before any
result is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-9, 1e-11           # tests/test_parity_dycore.py:27-28
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden" / "jw_case2.npz"
MAIN_STEPS = 10
K1_PER_STEP = 12   # 3 dynamics substeps x (1 + 1 + 2) acoustic iterations
K2_PER_STEP = 15   # 3 solve_diagnostics + 9 dyn_tend q + 3 transport


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_time_ms(fn, reps=20):
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels(device):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                                 acoustic_cell_update_plain,
                                                 example_args)
    from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain

    rel_tol = {"acoustic_cell_update": {torch.float64: 1e-12,
                                        torch.float32: 1e-5},
               "tinydot": {torch.float64: 1e-12, torch.float32: 1e-6}}
    results = {}
    rng = np.random.default_rng(0)
    nc, nz = 40962, 26
    for dtype in (torch.float64, torch.float32):
        args = {k: torch.from_numpy(v).to(device, dtype)
                for k, v in example_args(nc, nz).items()}
        got = acoustic_cell_update(nz, 0.1, 120.0, **args)
        ref = acoustic_cell_update_plain(nz, 0.1, 120.0, **args)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        tol = rel_tol["acoustic_cell_update"][dtype] * scale
        print(f"K1 acoustic_cell_update nC={nc} nz={nz} {dtype}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| "
              f"{scale:.3e})")
        require(err <= tol, "K1 disagrees with its plain version")
        if dtype == torch.float32:
            ms = cuda_time_ms(lambda: acoustic_cell_update(
                nz, 0.1, 120.0, **args))
            plain_ms = cuda_time_ms(lambda: acoustic_cell_update_plain(
                nz, 0.1, 120.0, **args))
            print(f"K1 f32 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results["acoustic_cell_update"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"nC={nc} nz={nz} float32")

    # the three contractions of the main path (ops/stencils.py and
    # advection.py): TRiSK at K=nz and K=2*nz, the second derivatives
    k2 = {}
    for P, I, K in ((6, 6, 26), (6, 6, 52), (3, 6, 26)):
        for dtype in (torch.float64, torch.float32):
            w = torch.from_numpy(rng.standard_normal((nc, P, I))).to(
                device, dtype)
            x = torch.from_numpy(rng.standard_normal((nc, I, K))).to(
                device, dtype)
            got, ref = tinydot(w, x), tinydot_plain(w, x)
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            tol = rel_tol["tinydot"][dtype] * scale
            print(f"K2 tinydot (nC,P,I,K)=({nc},{P},{I},{K}) {dtype}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e})")
            require(err <= tol, "K2 disagrees with its plain version")
            if dtype == torch.float32:
                ms = cuda_time_ms(lambda: tinydot(w, x))
                plain_ms = cuda_time_ms(lambda: tinydot_plain(w, x))
                print(f"K2 f32 time at P={P} K={K}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms")
                k2[(P, K)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  shape=f"nC={nc} P={P} I={I} K={K} "
                                        "float32")
    # the JSON line carries the shape of 9 of the 15 calls per step, and
    # the worst error over all three shapes
    results["tinydot"] = dict(
        k2[(6, 52)], max_abs_err=max(r["max_abs_err"] for r in k2.values()))
    return results


def jw_setup(n, lloyd_iters, nz, dt, len_disp):
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
    cfg = AtmConfig(config_nvertlevels=nz, config_len_disp=len_disp,
                    config_dt=dt, config_number_of_sub_steps=2)
    mesh = icosahedral_mesh(n, lloyd_iters=lloyd_iters)
    return (cfg, *init_jw(mesh, cfg, case=2))


def check_small_trajectory(device):
    """Phase 4: 24 f64 steps on the card vs the CPU (kernels vs plain)."""
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    cfg, grid, state, diag = jw_setup(8, 2, 10, 1200.0, 960000.0)
    outs = {}
    for dev in (torch.device("cpu"), device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), cfg.config_dt)
        t0 = time.perf_counter()
        out = run_steps(g, cfg, carry, cfg.config_dt, 24)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"small f64 trajectory on {dev.type}: 24 steps in "
              f"{time.perf_counter() - t0:.2f} s")
        outs[dev.type] = {k: getattr(out.state, k).cpu().numpy()
                          for k in ("u", "w", "theta_m", "rho_zz",
                                    "scalars")}
    for k, ref in outs["cpu"].items():
        err = np.abs(outs["cuda"][k] - ref)
        worst = float((err / (ATOL + RTOL * np.abs(ref))).max())
        print(f"  {k}: cuda vs cpu worst err/tol {worst:.3e}")
        require(np.isfinite(outs["cuda"][k]).all(), k)
        require(worst <= 1.0, f"{k}: CUDA f64 run departs from the CPU run")
    golden = np.load(GOLDEN)
    for k in golden.files:
        err = np.abs(outs["cuda"][k] - golden[k])
        worst = float((err / (ATOL + RTOL * np.abs(golden[k]))).max())
        print(f"  {k}: cuda vs {GOLDEN.name} worst err/tol {worst:.3e} "
              "(not asserted)")


def run_main_path(device, card):
    """Phase 5: jw_120km in float32 through the port's entry points."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, srk3_step)
    t0 = time.perf_counter()
    cfg, grid, state, diag = jw_setup(64, 4, 26, 720.0, 120000.0)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = grid.to(device, torch.float32)
    state = state.to(device, torch.float32)
    diag = diag.to(device, torch.float32)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nc, nz = grid.mesh.nCells, grid.vert.nz
    print(f"jw_120km setup: {nc} cells x {nz} levels; host build "
          f"{host_s:.2f} s, copy to card {copy_s:.2f} s")
    require((nc, nz) == (40962, 26), f"jw_120km built {nc} x {nz}")

    area = grid.mesh.areaCell.double()[:, None]
    mass0 = float((state.rho_zz.double() * area).sum())
    dt = cfg.config_dt
    kernels.reset_launch_counts()
    carry = init_carry(grid, cfg, state, diag, dt)
    carry = srk3_step(grid, cfg, carry, dt)                 # warm step
    torch.cuda.synchronize()
    before = dict(kernels.launch_counts)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        carry = srk3_step(grid, cfg, carry, dt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    steps = MAIN_STEPS + 1
    require(counts["acoustic_cell_update"] == K1_PER_STEP * steps, counts)
    require(counts["tinydot"] == K2_PER_STEP * steps + 1, counts)
    for name, per_step in (("acoustic_cell_update", K1_PER_STEP),
                           ("tinydot", K2_PER_STEP)):
        require(counts[name] - before[name] == per_step * MAIN_STEPS, counts)
    for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
        require(bool(torch.isfinite(getattr(carry.state, k)).all()), k)
    mass1 = float((carry.state.rho_zz.double() * area).sum())
    drift = abs(mass1 - mass0) / mass0
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"jw_120km float32 on {card}: {MAIN_STEPS} steps in "
          f"{elapsed:.3f} s = {ms:.2f} ms/step, "
          f"{nc * MAIN_STEPS / elapsed:.1f} cell-column updates/s; "
          f"peak device memory {peak_gb:.2f} GB; dry-mass drift "
          f"{drift:.3e}; launches {counts}")
    require(drift <= 1e-5, f"dry mass not conserved: {drift:.3e}")
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    from mpas_tpu_torch.kernels.build import load_library

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    klib = load_library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({klib.path.name}); nvcc/ptxas:\n{klib.log.strip()}")

    kernel_results = check_kernels(device)
    check_small_trajectory(device)
    counts = run_main_path(device, card)

    sources = {"acoustic_cell_update": ("mpas_tpu_torch/csrc/acoustic.cu",
                                        "mpas_tpu/kernels/acoustic.py:146"),
               "tinydot": ("mpas_tpu_torch/csrc/tinydot.cu",
                           "mpas_tpu/kernels/tinydot.py:44")}
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **kernel_results[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
