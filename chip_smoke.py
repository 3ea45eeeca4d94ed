#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mpas_tpu_torch) on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile DIR   # also a torch.profiler breakdown

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which asserts:

1. versions, and the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from mpas_tpu_torch/csrc;
3. each kernel against its plain PyTorch version at the shapes of both
   paths (jw_120km: 40,962 cells x 26 levels; supercell_2km: 9,216 cells
   x 40 levels), in float64 and float32, with kernel and plain times;
4. a small float64 JW trajectory (642 cells, 10 levels, 24 steps) on the
   card against the same run on the CPU, and the worst err/tol ratio
   against tests/golden/jw_case2.npz (printed only);
5. a small float64 moist supercell trajectory (144 cells, 16 levels,
   seeded cloud and rain, 6 steps with Kessler microphysics) on the card
   against the same run on the CPU;
6. the dry path: JW baroclinic wave on the 40,962-cell icosahedral mesh
   with 26 levels in float32 (setup, then timed steps), with finite
   fields, conserved dry mass and launch counts that prove every step
   went through both kernels;
7. the moist path: the supercell on the 9,216-cell doubly periodic 2-km
   hex mesh with 40 levels, Kessler microphysics and three transported
   scalars, in float32, from an initial state seeded with cloud and rain
   (so the timed steps rain), with finite fields, conserved dry mass and
   total water, and the launch counts of both kernels.

The second-to-last line is a JSON object with each kernel's numbers
(launches summed over both paths), the last one {"ok": true, "device":
{...}}. Without CUDA it fails before any result is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
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
SLICE_RTOL = 1e-9                  # tests/test_torch_supercell.py
K1_PER_STEP = 12   # 3 dynamics substeps x (1 + 1 + 2) acoustic iterations
# K2: 3 solve_diagnostics + 9 dyn_tend q + 3 transport stages per scalar
K2_PER_STEP = {"jw_120km": 3 + 9 + 3 * 1, "supercell_2km": 3 + 9 + 3 * 3}


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
    """Phase 3: each kernel against its plain version at both paths' shapes.
    Returns {(kernel, path, dtype, shape): numbers}."""
    from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                                 acoustic_cell_update_plain,
                                                 example_args)
    from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain

    rel_tol = {"acoustic_cell_update": {torch.float64: 1e-12,
                                        torch.float32: 1e-5},
               "tinydot": {torch.float64: 1e-12, torch.float32: 1e-6}}
    results = {}
    rng = np.random.default_rng(0)
    for path, nc, nz in (("jw_120km", 40962, 26),
                         ("supercell_2km", 9216, 40)):
        for dtype in (torch.float64, torch.float32):
            args = {k: torch.from_numpy(v).to(device, dtype)
                    for k, v in example_args(nc, nz).items()}
            got = acoustic_cell_update(nz, 0.1, 120.0, **args)
            ref = acoustic_cell_update_plain(nz, 0.1, 120.0, **args)
            scale = max(float(r.abs().max()) for r in ref)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            tol = rel_tol["acoustic_cell_update"][dtype] * scale
            ms = cuda_time_ms(lambda: acoustic_cell_update(
                nz, 0.1, 120.0, **args))
            plain_ms = cuda_time_ms(lambda: acoustic_cell_update_plain(
                nz, 0.1, 120.0, **args))
            print(f"K1 acoustic_cell_update {path} nC={nc} nz={nz} {dtype}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| "
                  f"{scale:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  "ms")
            require(err <= tol, "K1 disagrees with its plain version")
            results[("acoustic_cell_update", path, dtype, (nc, nz))] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"nC={nc} nz={nz} {str(dtype).split('.')[-1]}")

        # the path's contractions (ops/stencils.py and advection.py):
        # TRiSK at K=nz and K=2*nz, the second derivatives at K=nz
        for P, I, K in ((6, 6, nz), (6, 6, 2 * nz), (3, 6, nz)):
            for dtype in (torch.float64, torch.float32):
                w = torch.from_numpy(rng.standard_normal((nc, P, I))).to(
                    device, dtype)
                x = torch.from_numpy(rng.standard_normal((nc, I, K))).to(
                    device, dtype)
                got, ref = tinydot(w, x), tinydot_plain(w, x)
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                tol = rel_tol["tinydot"][dtype] * scale
                print(f"K2 tinydot {path} (nC,P,I,K)=({nc},{P},{I},{K}) "
                      f"{dtype}: max_abs_err {err:.3e} (tol {tol:.3e})")
                require(err <= tol, "K2 disagrees with its plain version")
                if dtype == torch.float32:
                    ms = cuda_time_ms(lambda: tinydot(w, x))
                    plain_ms = cuda_time_ms(lambda: tinydot_plain(w, x))
                    print(f"K2 f32 time {path} at P={P} K={K}: kernel "
                          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
                    results[("tinydot", path, dtype, (P, I, K))] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        shape=f"nC={nc} P={P} I={I} K={K} float32")
    return results


def kernel_json_numbers(results):
    """The JSON line's numbers per kernel: the times at the jw_120km f32
    shape of most of its calls, the worst f32 error over both paths."""
    out = {}
    for name, key in (("acoustic_cell_update", (40962, 26)),
                      ("tinydot", (6, 6, 52))):
        f32 = {k: v for k, v in results.items()
               if k[0] == name and k[2] == torch.float32}
        out[name] = dict(f32[(name, "jw_120km", torch.float32, key)],
                         max_abs_err=max(v["max_abs_err"]
                                         for v in f32.values()))
    return out


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


def supercell_setup(n, nz):
    """The supercell case on an n x n 2-km periodic mesh, its initial state
    seeded with cloud and rain (moisture.seeded_moisture) so that the
    first steps already run Kessler's condensation, rain and
    sedimentation."""
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
    from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=nz,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_kessler", config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(n, n, 2000.0), cfg,
                                       case=5)
    state = dataclasses.replace(
        state, scalars=seeded_moisture(grid.mesh, state.scalars, seed=7))
    return cfg, grid, state, diag


def check_small_supercell(device):
    """Phase 5: 6 f64 moist steps on the card vs the CPU."""
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    cfg, grid, state, diag = supercell_setup(12, 16)
    outs = {}
    for dev in (torch.device("cpu"), device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), cfg.config_dt)
        t0 = time.perf_counter()
        out = run_steps(g, cfg, carry, cfg.config_dt, 6)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"small f64 supercell on {dev.type}: 6 steps in "
              f"{time.perf_counter() - t0:.2f} s")
        outs[dev.type] = {k: getattr(out.state, k).cpu().numpy()
                          for k in ("u", "w", "theta_m", "rho_zz",
                                    "scalars")}
        outs[dev.type].update(rainnc=out.rainnc.cpu().numpy(),
                              rt_diabatic_tend=out.rt_diabatic_tend.cpu()
                              .numpy())
    require(float(outs["cpu"]["rainnc"].max()) > 0.0, "no rain reached "
            "the ground in the small supercell run")
    for k, ref in outs["cpu"].items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(outs["cuda"][k] - ref).max())
        print(f"  {k}: cuda vs cpu max abs err {err:.3e} (max|cpu| "
              f"{scale:.3e}, bound {SLICE_RTOL:g} x max|cpu|)")
        require(np.isfinite(outs["cuda"][k]).all(), k)
        require(err <= SLICE_RTOL * scale,
                f"{k}: CUDA f64 supercell run departs from the CPU run")


def run_path(name, device, card, setup):
    """Phases 6 and 7: one path at full size in float32 through the port's
    entry points: host setup, copy to the card, init_carry, one warm step,
    MAIN_STEPS timed steps; the launch counters are zeroed just before
    init_carry and read just after the last step."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.atmosphere.moisture import masses
    from mpas_tpu_torch.cores.atmosphere.physics import kessler
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, srk3_step)
    t0 = time.perf_counter()
    cfg, grid, state, diag = setup()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = grid.to(device, torch.float32)
    state = state.to(device, torch.float32)
    diag = diag.to(device, torch.float32)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nc, nz = grid.mesh.nCells, grid.vert.nz
    print(f"{name} setup: {nc} cells x {nz} levels, {state.scalars.shape[-1]}"
          f" scalar(s); host build {host_s:.2f} s, copy to card "
          f"{copy_s:.2f} s")

    dt = cfg.config_dt
    kernels.reset_launch_counts()
    kessler.reset_stats()
    carry = init_carry(grid, cfg, state, diag, dt)
    mass0 = masses(grid, carry)
    carry = srk3_step(grid, cfg, carry, dt)                 # warm step
    torch.cuda.synchronize()
    before = dict(kernels.launch_counts)
    sed = []
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        it0 = kessler.stats["sediment_iterations"]
        carry = srk3_step(grid, cfg, carry, dt)
        sed.append(kessler.stats["sediment_iterations"] - it0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    steps = MAIN_STEPS + 1
    k2 = K2_PER_STEP[name]
    require(counts["acoustic_cell_update"] == K1_PER_STEP * steps, counts)
    require(counts["tinydot"] == k2 * steps + 1, counts)
    for kname, per_step in (("acoustic_cell_update", K1_PER_STEP),
                            ("tinydot", k2)):
        require(counts[kname] - before[kname] == per_step * MAIN_STEPS,
                counts)
    for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
        require(bool(torch.isfinite(getattr(carry.state, k)).all()), k)
    mass1 = masses(grid, carry)
    drift = [abs(b - a) / a if a else 0.0 for a, b in zip(mass0, mass1)]
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in "
          f"{elapsed:.3f} s = {ms:.2f} ms/step, "
          f"{nc * MAIN_STEPS / elapsed:.1f} cell-column updates/s; "
          f"peak device memory {peak_gb:.2f} GB; dry-mass drift "
          f"{drift[0]:.3e}; launches {counts} "
          f"(per step: K1 {K1_PER_STEP}, K2 {k2})")
    require(drift[0] <= 1e-5, f"dry mass not conserved: {drift[0]:.3e}")
    return cfg, grid, carry, counts, drift, sed


def run_supercell_path(device, card):
    """Phase 7: supercell_2km (bench.py:104-119) in float32, from the
    seeded moist start: the timed steps carry cloud and rain."""
    cfg, grid, carry, counts, drift, sed = run_path(
        "supercell_2km", device, card, lambda: supercell_setup(96, 40))
    require((grid.mesh.nCells, grid.vert.nz) == (9216, 40),
            "supercell_2km built the wrong size")
    require(bool(torch.isfinite(carry.rainnc).all())
            and bool(torch.isfinite(carry.rt_diabatic_tend).all()),
            "non-finite rain or diabatic tendency")
    sc = carry.state.scalars
    require(float(sc[..., 2].max()) > 0.0 and float(sc[..., 1].max()) > 0.0,
            "supercell_2km ran its timed steps without cloud or rain")
    print(f"supercell_2km after {MAIN_STEPS + 1} steps: max w "
          f"{float(carry.state.w.max()):.4f} m/s, max qc "
          f"{float(sc[..., 1].max()):.4e}, max qr {float(sc[..., 2].max()):.4e}"
          f", max rainnc {float(carry.rainnc.max()):.4e} m; total-water "
          f"drift {drift[1]:.3e}; sedimentation iterations per timed step "
          f"{sed}")
    require(drift[1] <= 1e-5, f"total water not conserved: {drift[1]:.3e}")
    return cfg, grid, carry, counts


PROFILE_REGIONS = ("compute_dyn_tend", "acoustic_step", "solve_diagnostics",
                   "recover_large_step_variables", "vert_imp_coefs",
                   "set_smlstep_pert_variables", "advance_scalars",
                   "advance_scalars_mono", "microphysics_step",
                   "divergence_damping_3d", "acoustic_hoist",
                   "reconstruct_cell_winds", "compute_moist_coefficients")


def profile_supercell(cfg, grid, carry, out_dir, steps=3):
    """--profile DIR: torch.profiler over `steps` supercell steps, with a
    record_function span around each dycore call of srk3_step. Prints the
    device time per region and writes the per-kernel table to
    DIR/profile_supercell.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpas_tpu_torch.cores.atmosphere import time_integration as ti

    def spanned(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    saved = {n: getattr(ti, n) for n in PROFILE_REGIONS}
    try:
        for n, fn in saved.items():
            setattr(ti, n, spanned(n, fn))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                carry = ti.srk3_step(grid, cfg, carry, cfg.config_dt)
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(ti, n, fn)

    # CUDA-side events named after a region are the record_function spans
    # on the device timeline (first to last kernel, gaps included); the
    # rest are kernels
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.key not in PROFILE_REGIONS]
    span = {e.key: e.device_time_total for e in events
            if e.device_type == DeviceType.CUDA and e.key in PROFILE_REGIONS}
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) / steps
    print(f"profile ({steps} supercell steps): device busy {dev_ms:.3f} "
          f"ms/step over {n_kern:.0f} kernels/step")
    for label, prefix in (("K1", "void acoustic_cell_kernel"),
                          ("K2", "void tinydot_kernel")):
        ks = [e for e in kern if e.key.startswith(prefix)]
        print(f"  {label} {prefix[5:]}: "
              f"{sum(e.count for e in ks) / steps:.0f} launches/step, "
              f"{sum(e.self_device_time_total for e in ks) / 1e3 / steps:.3f}"
              " ms/step")
    for e in sorted((e for e in events if e.key in PROFILE_REGIONS
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.device_time_total):
        print(f"  region {e.key}: {e.count / steps:.0f} calls/step, "
              f"kernels {e.device_time_total / 1e3 / steps:.3f} ms/step, "
              f"device-timeline span "
              f"{span.get(e.key, 0.0) / 1e3 / steps:.3f} ms/step")
    table = events.table(sort_by="self_device_time_total", row_limit=60)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_supercell.txt").write_text(table)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  kernel {e.key[:70]}: {e.count / steps:.0f}/step, "
              f"{e.self_device_time_total / 1e3 / steps:.3f} ms/step")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile 3 supercell steps; the kernel "
                             "table goes to DIR/profile_supercell.txt")
    args = parser.parse_args()
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
    check_small_supercell(device)
    _, grid, _, jw_counts = run_path(
        "jw_120km", device, card,
        lambda: jw_setup(64, 4, 26, 720.0, 120000.0))[:4]
    require((grid.mesh.nCells, grid.vert.nz) == (40962, 26),
            "jw_120km built the wrong size")
    del grid
    cfg, grid, carry, sc_counts = run_supercell_path(device, card)
    if args.profile:
        profile_supercell(cfg, grid, carry, args.profile)

    numbers = kernel_json_numbers(kernel_results)
    sources = {"acoustic_cell_update": ("mpas_tpu_torch/csrc/acoustic.cu",
                                        "mpas_tpu/kernels/acoustic.py:146"),
               "tinydot": ("mpas_tpu_torch/csrc/tinydot.cu",
                           "mpas_tpu/kernels/tinydot.py:44")}
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": jw_counts[name] + sc_counts[name], **numbers[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
