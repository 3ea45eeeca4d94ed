#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mpas_tpu_torch) on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --profile DIR   # also torch.profiler breakdowns
    python3 chip_smoke.py --seed N        # real_120km's first guess (0)

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which asserts (each prints its
seconds):

1. versions, and the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from mpas_tpu_torch/csrc, one nvcc per source;
3. each kernel against its plain PyTorch version at the shapes of every
   path, in float64 and float32: K1 at jw_120km (40,962 cells x 26
   levels), supercell_2km (9,216 x 40), jw_var60_15 (23,000 x 26) and
   real_120km (40,962 x 55); K2 at the TRiSK and second-derivative
   contractions of the four atmosphere paths (maxEdges 6, and 8 on the
   variable-resolution mesh; K = 55 and 110 on real_120km), at the
   shallow-water TRiSK pair (K = 1 and 2), at the ocean channel's three
   (6,336 cells: the barotropic Coriolis reconstruction at K = 1, the
   baroclinic one at K = 20, the q-term at K = 40) and ocean_global_120km's
   (40,962 cells, K = 1, 60 and 120). Each kernel is timed on the device
   with the host excluded and the L2 cold (device_time_ms: a CUDA graph of
   launches rotating over copies of the inputs, >100 MB apart, replayed 7
   times; min / median / max ms per launch), beside the least time its
   bytes and operations allow (bound_ms), K2's one-call library
   equivalent (the einsum) timed the same way, the wrapper's host us per
   call, and the plain version's host-inclusive time, which is no
   yardstick;
4. small float64 trajectories on the card against the same runs on the
   CPU (phase 4b: the same in shards, phase 4c: over NCCL): JW (642 cells, 10 levels, 24 steps; worst err/tol against
   tests/golden/jw_case2.npz printed only), shallow-water TC5 (642
   cells, 48 steps; against tests/golden/sw_tc5.npz printed only), JW on
   a 1,200-cell variable-resolution mesh (10 levels, 3 steps, mesh
   scaling on, a quarter of the Earth's radius), the moist supercell
   (144 cells, 16 levels, seeded cloud and rain, 6 steps with Kessler
   microphysics), the same supercell with six species and WSM6 (6 steps;
   both runs conserve total water, six species + rainnc, and dry mass to
   1e-10), with WSM6 and the mesoscale_reference physics suite (6 coupled
   steps), JW on the 642-cell sphere with six zero species, WSM6 and the
   suite (3 steps; the suite's runs held at 1e-11 x max), the supercell
   with eight species, Thompson and the convection_permitting suite (6
   coupled steps at 07:00; rain, qke finite and >= 0), with WSM6 and the
   default PhysicsConfig() (Kain-Fritsch, 6 coupled steps at 07:00), and
   kf_eta alone on 24 deep unstable columns (40 levels to 25 km; it fires
   in every column), the supercell with WSM6 and the mesoscale_reference
   suite under CAM radiation with the supercell namelist's dissipation
   (2d_fixed, vertical eddy viscosities; 6 coupled steps at 07:00), JW
   with Rayleigh damping of u and both vertical eddy viscosities (3
   steps), rrtmg_lw/rrtmg_sw with an o3_climatology profile and the urban
   canopy (10 slucm_step calls, bep_column_drag, bep_heat_sources) and
   oml_step on 9,216 columns, all held at 1e-11 x max; the ocean's
   baroclinic channel (192 cells, 10 levels: 3 split-explicit steps of
   300 s and 4 RK4 steps of 30 s); the real-data init from a seeded
   5-degree first guess on the 642-cell sphere (10 levels, 3 steps, qv
   >= 0); and the regional zones (relaxation nudging, specified-zone
   reset on cells, edges and a 3-D field, the LBC time interpolation) and
   the IAU tendencies inside and after their window on the 8,836-cell
   box_hex_mesh(96, 96, 3 km) at 55 levels, all held at 1e-11 x max;
   each of the ocean's 15 init configurations (cores/ocean/init_configs.py
   on the 192-cell channel and plane, a 132-cell box and the 642-cell
   sphere, 6 levels) and init_global_ocean from synthetic_woa_dataset()
   on the 642-cell sphere (10 levels), each followed by 2 steps of its
   reference test's integrator, and ISOMIP+ with apply_land_ice_fluxes
   between 3 split steps, held at 1e-11 x max (cvmix_wswsbf, whose 2
   cvmix steps depart 8.4e-11 x max, at 5e-10 x max); bgc_step with
   DMS, ecosys_step and carbon_step on 24 columns at 1e-11 x max; a
   ForcingGroup over a 3-record file written here (constant, linear,
   cyclic) equal to the CPU's, and build_state_pytree on the card from a
   Registry.xml written here;
   4b. small float64 sharded runs on the card, all shards in one process
   (loopback), held to the same runs unsharded on the card at 1e-11 x
   max: JW (642 cells, 10 levels, 3 steps) on 2 and 4 shards, the ocean
   channel (192 cells, 3 split steps) and shallow-water TC5 (642 cells, 5
   steps) on 4;
   4c. the process-group transport on NCCL, 2 ranks on 2 cards, the small
   JW held to loopback at 1e-11, where the machine has two cards;
5. the full-size paths in float32 (setup, then timed steps), each with
   finite fields, conserved mass and launch counts that prove every step
   went through its kernels:
   - jw_120km: JW baroclinic wave on the 40,962-cell icosahedral mesh, 26
     levels (12 K1 and 15 K2 launches per step);
   - sw_tc5_120km: shallow-water test case 5 on the same mesh, dt = 45 s,
     RK4 (8 K2 launches per step, no K1);
   - real_120km: the real-data atmosphere (init case 7) on the same mesh,
     written as a netCDF4 grid file and read back (every array bit for
     bit with the generated mesh), from a seeded GFS-like first guess on
     the 0.5-degree 720 x 361 grid at 26 levels written as a WPS
     intermediate file and read back; init_real to 55 levels under 30
     km, dt = 720 s, one scalar (qv), no microphysics (12 K1 and 15 K2
     launches per step); dry mass and total qv conserved to 1e-5, qv >= 0
     to float32 rounding, max |u| < 150 m/s; the host seconds of the
     grid file, the met file and init_real (vertical_interp's share);
   - supercell_2km: the supercell on the 9,216-cell doubly periodic 2-km
     hex mesh with 40 levels, Kessler microphysics and three transported
     scalars, from an initial state seeded with cloud and rain (so the
     timed steps rain), also conserving total water;
   - supercell_2km_mesoref: the same with WSM6 and six species, and the
     mesoscale_reference suite (cldfra3, RRTMG-class LW/SW, MM5 surface
     layer, Noah, YSU, GWDO, new Tiedtke) before every dynamics step
     through run_steps_with_physics at 07:00 solar time (12 K1 and 30
     K2 launches per step,
     none from the suite); dry mass, non-negative species, rain at the
     ground, a moving skin temperature, downward longwave after the
     radiation-due warm step (timed on its own);
   - supercell_2km_convperm: the same with Thompson, eight species (nr and
     ni from 1e-2) and the convection_permitting suite (Grell-Freitas,
     MYNN PBL and surface layer, RRTMG-class radiation, cldfra3, GWDO,
     Noah) at 07:00 (12 K1 and 36 K2 launches per step); the numbers in
     [1e-2, 1e8], qke finite and >= 0, rain;
   - supercell_2km_kf: supercell_2km_mesoref's grid and start with the
     driver hook's default PhysicsConfig() (Kain-Fritsch, YSU, MM5 surface
     layer, slab LSM, broadband radiation) at 07:00 (12 K1 and 30 K2 a
     step); the columns Kain-Fritsch activated, the largest rainc and
     kf_eta's kernels and device ms a call;
   - supercell_2km_cam: supercell_2km_mesoref with CAM radiation in place
     of RRTMG and the MPAS-A supercell namelist's dissipation (2d_fixed,
     horizontal and vertical eddy viscosities of 500 m^2/s, no del4), at
     07:00 (12 K1 and 30 K2 a step), mesoref's gates; cam_lw's and
     cam_sw's device ms. The four suite paths print their kernels and
     device busy ms a step from one profiled step;
   - jw_var60_15: JW on the 23,000-cell 60-15 km variable-resolution mesh
     (maxEdges 8) of a quarter-radius planet, 26 levels, dt = 90 s, with
     mesh-scaled dissipation (12 K1 and 15 K2 launches per step);
   - ocean_channel_10km: the ocean's baroclinic channel on the 6,336-cell
     10-km channel mesh, 20 levels, split-explicit at dt = 300 s (245 K2
     launches per step, from the config: 240 in the barotropic subcycles,
     no K1), conserving volume and heat, salinity uniform, walls closed;
   - ocean_global_120km: the global ocean (mpas_tpu_torch.tools.
     ocean_global) on jw_120km's 40,962-cell mesh, init_global_ocean from
     a WOA-shaped 1-degree, 102-level dataset at 60 layers, 12 tracers
     (T, S, 8 ecosys pools, DIC, ALK), split-explicit at dt = 900 s
     (btr 60 s; 1,800 s turns non-finite at step 6: python -m
     mpas_tpu_torch.tools.ocean_global) under the init's wind, then
     ecosys_step and carbon_step; all 19 analysis members every 2 steps
     and four particle trackers (one per vertical treatment, one particle
     per ocean cell) every step: volume conserved, BGC pools >= 0, max |u|
     < 5 m/s, 185 K2 launches in each step's dynamics (no K1), every
     particle in an ocean cell; one profiled step with the shares of
     dynamics, BGC, analysis and particles, each member's device ms; then
     the members and one particle step in f64 on the card and the CPU at
     1e-11 x max;
   5b. jw_120km_4way: jw_120km sharded 4 ways by sfc_partition (halo
     depth 4), float32, loopback on the card from jw_120km's start: the
     layout's host seconds, flat sizes and halo volume per depth, 12 K1 +
     15 K2 launches a step, dry mass over owned cells, and the gathered
     u, w, theta_m, rho_zz within the reference's f32 allowance, 2e-4 on
     max |a - b| / (1 + |b|), of jw_120km's after the same 11 steps; its
     carry written as restart shards (io/sharded.py, group_size 2), read
     back (bit for bit with the gathered fields) and 2 steps from it bit
     for bit with 2 steps from the carry in memory; then jw_120km and
     jw_120km_4way timed in turns (A, B, B, A, 5 steps each); phase 3 at
     its flat K1/K2 shapes;
   5c. ocean_channel_10km_4way: the same for the ocean channel (245 K2 a
     step, volume and heat over owned cells, u, h and tracers, the turns
     against ocean_channel_10km);
   5d. the diagnostics manager (isobaric, convective, pv and reflectivity)
     on supercell_2km_cam's final state, and isobaric, convective and pv
     on jw_120km's: once in f32 on the card (its seconds printed), then in
     f64 from that state on the card and on the CPU, held at 1e-11 x max
     with the same NaN positions;
6. the command line (mpas_tpu_torch.__main__.main, in this process, each
   run in a fresh temporary directory, float32, its mesh cache seeded
   with phase 5's 40,962-cell mesh under the key icos64_l4):
   - jw_120km: `atmosphere --mesh icos:64 --duration 2:00:00 -s
     streams.atmosphere` (10 steps of 720 s; output and restart every
     hour), then a restart from the 01h restart for the last hour in the
     same directory; outputs at 00h, 01h and 02h and restarts at 01h and
     02h; 12 K1 + 15 K2 launches a step in both runs (and one K2 for each
     init_carry: setup, and resume on restart); the final output equal to
     a direct run_steps of 10 steps from HOOKS.setup at max |a - b| /
     (1 + |b|) <= 2e-4 (bit for bit or not is printed), the restarted
     run's to the continuous run's; the driver's timer table, its ms/step
     beside phase 5's, the seconds of stream output, each file's size;
   - sw_tc5_120km: `sw --mesh icos:64 --dt 45`, 4 steps (8 K2 a step);
   - ocean_channel_10km: `ocean --mesh channel:32,200,10000`, 4 steps of
     300 s (245 K2 a step); each final output held to a direct run_steps
     at the same bound;
   - jw_120km from real_120km's netCDF4 grid file: `atmosphere --mesh
     file:<x1.40962.grid.nc> --duration 0:24:00` (2 steps), its final
     output held to the same 2 steps with `--mesh icos:64` at the same
     bound (bit for bit or not is printed).

The second-to-last line is a JSON object with each kernel's numbers at
its jw_120km float32 shape (launches summed over the thirteen paths and
the command line's six runs), the last one {"ok": true, "device":
{...}}. Without CUDA it fails before any result is printed.

--profile DIR adds torch.profiler breakdowns of 3 steps of each of the
thirteen paths.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-9, 1e-11           # tests/test_parity_dycore.py:27-28
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden" / "jw_case2.npz"
SW_GOLDEN = GOLDEN.with_name("sw_tc5.npz")
MAIN_STEPS = 10
SLICE_RTOL = 1e-9                  # tests/test_torch_supercell.py
K1_PER_STEP = 12   # 3 dynamics substeps x (1 + 1 + 2) acoustic iterations
# K2: 3 solve_diagnostics + 9 dyn_tend q + 3 transport stages per scalar
K2_PER_STEP = {"jw_120km": 3 + 9 + 3 * 1, "supercell_2km": 3 + 9 + 3 * 3,
               "real_120km": 3 + 9 + 3 * 1,
               "jw_var60_15": 3 + 9 + 3 * 1,
               "supercell_2km_mesoref": 3 + 9 + 3 * 6,
               "supercell_2km_convperm": 3 + 9 + 3 * 8,
               "supercell_2km_kf": 3 + 9 + 3 * 6,
               "supercell_2km_cam": 3 + 9 + 3 * 6}
PHYS_RTOL = 1e-11                  # the suite's f64 card-vs-CPU runs
# the suite paths' solar time (the plane's lon is 0): 07:00, sun up. At
# the reference's default noon the Noah skin temperature, explicit in the
# surface fluxes, diverges over clear cells within a few steps, in both
# packages (tests/test_torch_mesoref_slice.py)
MESOREF_GMT = 7.0
WATER_RTOL = 1e-10                 # tests/test_torch_mesoref_slice.py
# the MPAS-A supercell case's namelist dissipation (supercell_2km_cam)
SUPERCELL_DISSIPATION = dict(config_horiz_mixing="2d_fixed",
                             config_h_mom_eddy_visc2=500.0,
                             config_h_theta_eddy_visc2=500.0,
                             config_v_mom_eddy_visc2=500.0,
                             config_v_theta_eddy_visc2=500.0,
                             config_h_mom_eddy_visc4=0.0,
                             config_h_theta_eddy_visc4=0.0)
URBAN_CELLS = 9216                 # supercell_2km's columns
SW_K2_PER_STEP = 4 * 2             # 4 RK stages x (tangential + q pair)
OCEAN_CELLS = 6336                 # channel_hex_mesh(32, 200, 10 km)
OCEAN_NZ = 20
# (path, nC, nz) of K1, and (path, nC, (P, I, K) ...) of K2
K1_SHAPES = (("jw_120km", 40962, 26), ("supercell_2km", 9216, 40),
             ("jw_var60_15", 23000, 26), ("real_120km", 40962, 55))
K2_SHAPES = (("jw_120km", 40962, ((6, 6, 26), (6, 6, 52), (3, 6, 26))),
             ("supercell_2km", 9216, ((6, 6, 40), (6, 6, 80), (3, 6, 40))),
             ("jw_var60_15", 23000, ((8, 8, 26), (8, 8, 52), (3, 8, 26))),
             ("real_120km", 40962, ((6, 6, 55), (6, 6, 110), (3, 6, 55))),
             ("sw_tc5_120km", 40962, ((6, 6, 1), (6, 6, 2))),
             ("ocean_channel_10km", OCEAN_CELLS, ((6, 6, 1), (6, 6, 20),
                                                  (6, 6, 40))),
             ("ocean_global_120km", 40962, ((6, 6, 1), (6, 6, 60),
                                            (6, 6, 120))))


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
PEAK_OPS = {torch.float32: 67e12,  # outside the tensor cores, same source
            torch.float64: 34e12}
COLD_L2_BYTES = 100e6              # more than the 50 MB L2 between reuses


def bound(nbytes, ops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def rotating_copies(args, nbytes):
    """args (a dict of tensors) and enough clones of it that more than
    COLD_L2_BYTES of other calls' data lie between two uses of one copy."""
    n = int(COLD_L2_BYTES // nbytes) + 2
    return [args] + [{k: v.clone() for k, v in args.items()}
                     for _ in range(n - 1)]


def device_time_ms(fn, copies, reps=7, min_launches=20):
    """Device ms per call of fn(copy), host excluded: one CUDA graph holds
    >= min_launches calls rotating over `copies` (a cold L2 where they come
    from rotating_copies); each of `reps` replays is timed with CUDA
    events. Returns (min, median, max) over the replays."""
    n = len(copies) * -(-min_launches // len(copies))
    for c in copies:                 # warm-up, outside the capture
        fn(c)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for j in range(n):
            fn(copies[j % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    del graph
    times.sort()
    return times[0], times[len(times) // 2], times[-1]


def host_us(fn, copies, calls=50):
    """Host microseconds per call of fn(copy), launches queued, no sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(calls):
        fn(copies[j % len(copies)])
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def graph_floor_ms(device):
    """Device ms per launch of a graph of 1-element adds: what a graph
    replay adds to every launch it times."""
    t = torch.zeros(1, device=device)
    return device_time_ms(lambda c: c["t"].add_(1.0), [{"t": t}],
                          min_launches=200)


def timing_numbers(fn, copies, nbytes, ops, dtype, library=None):
    """The device-time numbers of one kernel at one shape; `library`, a
    function of a copy, is timed the same way where there is one."""
    lo, med, hi = device_time_ms(fn, copies)
    b_ms, b_by = bound(nbytes, ops, dtype)
    out = dict(ms=med, ms_min=lo, ms_max=hi, bound_ms=b_ms, bound_by=b_by,
               pct_of_bound=100.0 * b_ms / med, library_ms=None,
               host_us=host_us(fn, copies), bytes=nbytes)
    if library is not None:
        out["library_ms"] = device_time_ms(library, copies)[1]
    return out


def timing_text(t):
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    return (f"device {t['ms_min']:.4f} / {t['ms']:.4f} / {t['ms_max']:.4f} "
            f"ms (min/median/max, cold L2), bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({t['bytes'] / 1e6:.1f} MB), "
            f"{t['pct_of_bound']:.1f}% of bound; library {lib}; wrapper "
            f"host {t['host_us']:.1f} us/call")


def cuda_time_ms(fn, reps=20):
    """Mean ms per call from CUDA events around `reps` calls, after one
    warm-up call; host work included (the plain versions' timing)."""
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


def check_kernels(device, k1_shapes=K1_SHAPES, k2_shapes=K2_SHAPES):
    """Phase 3: each kernel against its plain version at every path's
    shapes, and timed on the device. Returns {(kernel, path, dtype,
    shape): numbers}."""
    from mpas_tpu_torch.kernels import acoustic, tinydot as k2

    rel_tol = {"acoustic_cell_update": {torch.float64: 1e-12,
                                        torch.float32: 1e-5},
               "tinydot": {torch.float64: 1e-12, torch.float32: 1e-6}}
    print(f"graph floor (1-element add): {graph_floor_ms(device)[1]:.4f} "
          "ms per launch")
    results = {}
    rng = np.random.default_rng(0)
    for path, nc, nz in k1_shapes:
        for dtype in (torch.float64, torch.float32):
            args = {k: torch.from_numpy(v).to(device, dtype)
                    for k, v in acoustic.example_args(nc, nz).items()}
            got = acoustic.acoustic_cell_update(nz, 0.1, 120.0, **args)
            ref = acoustic.acoustic_cell_update_plain(nz, 0.1, 120.0, **args)
            scale = max(float(r.abs().max()) for r in ref)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            tol = rel_tol["acoustic_cell_update"][dtype] * scale
            del got, ref
            size = args["rs_pre"].element_size()
            nbytes = acoustic.bytes_moved(nc, nz, size)
            t = timing_numbers(
                lambda a: acoustic.acoustic_cell_update(nz, 0.1, 120.0, **a),
                rotating_copies(args, nbytes), nbytes,
                acoustic.operations(nc, nz), dtype)
            plain_ms = cuda_time_ms(lambda: acoustic
                                    .acoustic_cell_update_plain(
                                        nz, 0.1, 120.0, **args))
            print(f"K1 acoustic_cell_update {path} nC={nc} nz={nz} {dtype}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| "
                  f"{scale:.3e}); (cols, threads) "
                  f"{acoustic.plan(nz, size)[:2]}; {timing_text(t)}; plain "
                  f"{plain_ms:.4f} ms (host-inclusive events, no yardstick)")
            require(err <= tol, "K1 disagrees with its plain version")
            results[("acoustic_cell_update", path, dtype, (nc, nz))] = dict(
                max_abs_err=err, plain_ms=plain_ms, **t,
                shape=f"nC={nc} nz={nz} {str(dtype).split('.')[-1]}")

    # the paths' contractions (ops/stencils.py and advection.py): TRiSK
    # at K = nz and 2*nz (1 and 2 on the shallow-water path), the second
    # derivatives at K = nz; padded slots carry zero weight
    for path, nc, shapes in k2_shapes:
        for P, I, K in shapes:
            for dtype in (torch.float64, torch.float32):
                w = np.where(rng.uniform(size=(nc, 1, I)) < 0.3, 0.0,
                             rng.standard_normal((nc, P, I)))
                w = torch.from_numpy(w).to(device, dtype)
                x = torch.from_numpy(rng.standard_normal((nc, I, K))).to(
                    device, dtype)
                got, ref = k2.tinydot(w, x), k2.tinydot_plain(w, x)
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                tol = rel_tol["tinydot"][dtype] * scale
                print(f"K2 tinydot {path} (nC,P,I,K)=({nc},{P},{I},{K}) "
                      f"{dtype}: max_abs_err {err:.3e} (tol {tol:.3e})")
                require(err <= tol, "K2 disagrees with its plain version")
                if dtype != torch.float32:
                    continue
                nbytes = k2.bytes_moved(nc, P, I, K, w.element_size())
                t = timing_numbers(
                    lambda a: k2.tinydot(a["w"], a["x"]),
                    rotating_copies({"w": w, "x": x}, nbytes), nbytes,
                    k2.operations(nc, P, I, K), dtype,
                    library=lambda a: torch.einsum("cpi,cik->cpk", a["w"],
                                                   a["x"]))
                plain_ms = cuda_time_ms(lambda: k2.tinydot_plain(w, x))
                print(f"K2 f32 time {path} at (P,I,K)=({P},{I},{K}), "
                      f"(cols, threads) {k2.plan(P, I, K, 4)[:2]}: "
                      f"{timing_text(t)}; plain {plain_ms:.4f} ms "
                      "(host-inclusive events, no yardstick)")
                results[("tinydot", path, dtype, (P, I, K))] = dict(
                    max_abs_err=err, plain_ms=plain_ms, **t,
                    shape=f"nC={nc} P={P} I={I} K={K} float32")
    return results


def kernel_json_numbers(results):
    """The JSON line's numbers per kernel: the times and bound at the
    jw_120km f32 shape of most of its calls, the worst f32 error over all
    shapes."""
    keys = ("ms", "ms_min", "ms_max", "plain_ms", "bound_ms", "bound_by",
            "pct_of_bound", "library_ms", "shape")
    out = {}
    for name, key in (("acoustic_cell_update", (40962, 26)),
                      ("tinydot", (6, 6, 52))):
        f32 = {k: v for k, v in results.items()
               if k[0] == name and k[2] == torch.float32}
        at = f32[(name, "jw_120km", torch.float32, key)]
        out[name] = dict({k: at[k] for k in keys},
                         max_abs_err=max(v["max_abs_err"]
                                         for v in f32.values()))
    return out


def jw_setup(mesh, nz, dt, len_disp, radius_scale=1.0, **cfg_kw):
    """JW case 2 on a unit-sphere mesh scaled to radius_scale x the
    Earth's radius; cfg_kw goes to AtmConfig."""
    from mpas_tpu_torch.constants import a
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
    cfg = AtmConfig(config_nvertlevels=nz, config_len_disp=len_disp,
                    config_dt=dt, config_number_of_sub_steps=2, **cfg_kw)
    return (cfg, *init_jw(mesh, cfg, case=2, radius=a * radius_scale))


def jw_var_setup(n_points, iterations, nz, dt, len_disp):
    """JW case 2 on the 4:1 refined variable-resolution mesh of a
    quarter-radius planet with mesh-scaled dissipation (bench.py:67-77)."""
    from mpas_tpu_torch.mesh.varres import variable_res_mesh
    mesh = variable_res_mesh(n_points, iterations=iterations)
    return jw_setup(mesh, nz, dt, len_disp, radius_scale=0.25,
                    config_h_ScaleWithMesh=True)


def with_passive_scalar(grid, state):
    """A smooth passive scalar in place of JW's zero one, so that the
    transport of a small trajectory moves something."""
    lat = grid.mesh.latCell[:, None, None]
    lon = grid.mesh.lonCell[:, None, None]
    return dataclasses.replace(state, scalars=(
        1.0 + torch.sin(2.0 * lon) * torch.cos(lat))
        * torch.ones_like(state.scalars))


STATE_FIELDS = ("u", "w", "theta_m", "rho_zz", "scalars")


def atm_runs(label, device, cfg, grid, state, diag, steps):
    """The same float64 atmosphere run on the CPU (plain versions) and on
    the card (kernels); returns {"cpu": carry, "cuda": carry}."""
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    outs = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), cfg.config_dt)
        t0 = time.perf_counter()
        outs[where] = run_steps(g, cfg, carry, cfg.config_dt, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"small f64 {label} on {where}: {steps} steps in "
              f"{time.perf_counter() - t0:.2f} s")
    return outs


def compare_err_tol(label, fields, golden):
    """Hold the card's fields to the CPU's at RTOL/ATOL (asserted), then
    print their distance to a golden file (not asserted)."""
    for k, ref in fields["cpu"].items():
        err = np.abs(fields["cuda"][k] - ref)
        worst = float((err / (ATOL + RTOL * np.abs(ref))).max())
        print(f"  {k}: cuda vs cpu worst err/tol {worst:.3e}")
        require(np.isfinite(fields["cuda"][k]).all(), k)
        require(worst <= 1.0, f"{k}: CUDA f64 {label} run departs from the "
                "CPU run")
    ref = np.load(golden)
    for k in ref.files:
        err = np.abs(fields["cuda"][k] - ref[k])
        worst = float((err / (ATOL + RTOL * np.abs(ref[k]))).max())
        print(f"  {k}: cuda vs {golden.name} worst err/tol {worst:.3e} "
              "(not asserted)")


def compare_scaled(label, fields, rel=SLICE_RTOL):
    """Hold the card's fields to the CPU's at rel x max|cpu|."""
    for k, ref in fields["cpu"].items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(fields["cuda"][k] - ref).max())
        print(f"  {k}: cuda vs cpu max abs err {err:.3e} (max|cpu| "
              f"{scale:.3e}, bound {rel:g} x max|cpu|)")
        require(np.isfinite(fields["cuda"][k]).all(), k)
        require(err <= rel * scale,
                f"{k}: CUDA f64 {label} run departs from the CPU run")


def state_fields(carry):
    return {k: getattr(carry.state, k).cpu().numpy() for k in STATE_FIELDS}


def check_small_trajectory(device, mesh8):
    """Phase 4: 24 f64 JW steps on the card vs the CPU (kernels vs plain)."""
    outs = atm_runs("JW", device, *jw_setup(mesh8, 10, 1200.0, 960000.0), 24)
    compare_err_tol("JW", {w: state_fields(c) for w, c in outs.items()},
                    GOLDEN)


def check_small_sw(device, mesh8):
    """Phase 4: 48 f64 shallow-water TC5 steps (dt = 900 s) on the card vs
    the CPU, the setup of tests/test_parity_dycore.py:_sw_trajectory."""
    from mpas_tpu_torch.cores.sw import test_cases
    from mpas_tpu_torch.cores.sw.config import SWConfig
    from mpas_tpu_torch.cores.sw.time_integration import run_steps
    mesh, state, h_s = test_cases.test_case_5(mesh8)
    cfg = SWConfig(config_dt=900.0, config_test_case=5)
    fields = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        f64 = torch.float64
        t0 = time.perf_counter()
        out = run_steps(mesh.to(dev, f64), cfg, state.to(dev, f64),
                        h_s.to(dev, f64), 48)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"small f64 sw_tc5 on {where}: 48 steps in "
              f"{time.perf_counter() - t0:.2f} s")
        fields[where] = {k: getattr(out, k).cpu().numpy()
                         for k in ("u", "h", "tracers")}
    compare_err_tol("SW", fields, SW_GOLDEN)


def check_small_varres(device):
    """Phase 4: 3 f64 JW steps on a 1,200-cell variable-resolution mesh
    (maxEdges 8, mesh scaling on, quarter radius) on the card vs the
    CPU, as tests/test_torch_varres.py runs them against the reference."""
    from mpas_tpu_torch.mesh.varres import variable_res_mesh
    mesh = variable_res_mesh(1200, iterations=20, seed=0)
    require(mesh.maxEdges == 8, f"varres maxEdges {mesh.maxEdges}")
    cfg, grid, state, diag = jw_setup(mesh, 10, 300.0, 60000.0,
                                      radius_scale=0.25,
                                      config_h_ScaleWithMesh=True)
    outs = atm_runs("varres JW", device, cfg, grid,
                    with_passive_scalar(grid, state), diag, 3)
    compare_scaled("varres", {w: state_fields(c) for w, c in outs.items()})


def supercell_setup(n, nz, scheme="mp_kessler", **cfg_kw):
    """The supercell case on an n x n 2-km periodic mesh, its initial state
    seeded with cloud and rain (moisture.seeded_moisture) so that the
    first steps already run the microphysics' condensation, rain and
    sedimentation. With mp_wsm6 the state carries six species, (qi, qs,
    qg) zero, as tests/test_atm_physics.py widens it; with mp_thompson
    eight, the numbers (nr, ni) at 1e-2 as
    tests/test_atm_scheme_variants.py widens it. cfg_kw goes to
    AtmConfig."""
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
    from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=nz,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme=scheme, config_monotonic=True,
                    **cfg_kw)
    grid, state, diag = init_supercell(planar_hex_mesh(n, n, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, seed=7)
    if scheme in ("mp_wsm6", "mp_thompson"):
        sc = torch.cat([sc, torch.zeros_like(sc)], dim=-1)
    if scheme == "mp_thompson":
        sc = torch.cat([sc, torch.full_like(sc[..., :2], 1e-2)], dim=-1)
    return cfg, grid, dataclasses.replace(state, scalars=sc), diag


def suite_config(suite):
    """PhysicsConfig of a suite, every scheme left at the 'suite' sentinel
    and resolved (tests/test_physics_suite.py)."""
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        SCHEME_FIELDS, PhysicsConfig, resolve_suite)
    return resolve_suite(PhysicsConfig(
        config_physics_suite=suite, **{k: "suite" for k in SCHEME_FIELDS}))


def cam_config():
    """The resolved mesoscale_reference suite with CAM radiation in place
    of RRTMG."""
    return dataclasses.replace(suite_config("mesoscale_reference"),
                               config_radiation_scheme="cam")


MESOREF_INIT = dict(lsm_scheme="noah")
CONVPERM_INIT = dict(lsm_scheme="noah", pbl_scheme="mynn")


def suite_runs(label, device, cfg, grid, state, diag, steps,
               pcfg="mesoscale_reference", init_kw=MESOREF_INIT,
               gmt_hours=12.0):
    """The same float64 coupled run (physics_step, then srk3_step) on the
    CPU and on the card, through run_steps_with_physics with the resolved
    suite `pcfg` (a suite's name, a PhysicsConfig, or None for
    PhysicsConfig()) from init_physics_state(**init_kw); returns {"cpu":
    (carry, phys), "cuda": (carry, phys)}."""
    from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        init_physics_state)
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs
    if isinstance(pcfg, str):
        pcfg = suite_config(pcfg)
    coeffs = torch.from_numpy(build_reconstruct_coeffs(grid.mesh))
    nc, nz = grid.mesh.nCells, grid.vert.nz
    outs = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        f64 = torch.float64
        g = grid.to(dev, f64)
        carry = init_carry(g, cfg, state.to(dev, f64), diag.to(dev, f64),
                           cfg.config_dt)
        phys = init_physics_state(nc, nz, dtype=f64, device=dev, **init_kw)
        t0 = time.perf_counter()
        outs[where] = run_steps_with_physics(
            g, cfg, carry, phys, coeffs.to(dev, f64), cfg.config_dt, steps,
            pcfg=pcfg, gmt_hours=gmt_hours)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"small f64 {label} on {where}: {steps} steps in "
              f"{time.perf_counter() - t0:.2f} s")
    return outs


PHYS_FIELDS = ("tsk", "rainc", "hpbl", "glw", "gsw", "rad_tend", "tslb",
               "smois", "qke")


def suite_fields(carry, phys):
    """The state, rainnc, rt_diabatic_tend and the physics state's fields
    the run carries (the soil with Noah, qke with MYNN); Thompson's rain
    and ice numbers apart from the species, each at its own scale."""
    out = state_fields(carry)
    sc = out["scalars"]
    if sc.shape[-1] == 8:
        out.update(scalars=sc[..., :6], numbers=sc[..., 6:])
    out.update(rainnc=carry.rainnc.cpu().numpy(),
               rt_diabatic_tend=carry.rt_diabatic_tend.cpu().numpy())
    out.update({k: getattr(phys, k).cpu().numpy() for k in PHYS_FIELDS
                if getattr(phys, k) is not None})
    return out


def check_small_wsm6(device):
    """Phase 4: 6 f64 steps of the 144-cell, 16-level supercell with WSM6
    alone, card vs CPU; both conserve dry mass and total water (six
    species + rainnc) to WATER_RTOL."""
    from mpas_tpu_torch.cores.atmosphere.moisture import masses
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    cfg, grid, state, diag = supercell_setup(12, 16, "mp_wsm6")
    outs = atm_runs("supercell WSM6", device, cfg, grid, state, diag, 6)
    start = masses(grid, init_carry(grid, cfg, state, diag, cfg.config_dt))
    fields = {}
    for where, carry in outs.items():
        g = grid.to(carry.rainnc.device, torch.float64)
        drift = [abs(b - a) / a for a, b in zip(start, masses(g, carry))]
        print(f"  {where}: dry-mass drift {drift[0]:.3e}, total-water "
              f"(6 species + rainnc) drift {drift[1]:.3e}")
        require(max(drift) <= WATER_RTOL, f"WSM6 on {where} loses mass")
        fields[where] = state_fields(carry)
        fields[where].update(rainnc=carry.rainnc.cpu().numpy(),
                             rt_diabatic_tend=carry.rt_diabatic_tend.cpu()
                             .numpy())
    require(float(fields["cpu"]["rainnc"].max()) > 0.0
            and float(fields["cpu"]["scalars"][..., 3:6].max()) > 0.0,
            "the small WSM6 run made no rain or no ice-phase species")
    compare_scaled("supercell WSM6", fields, PHYS_RTOL)


def check_small_suite(device):
    """Phase 4: 6 f64 coupled steps of the same supercell with the
    mesoscale_reference suite and WSM6, card vs CPU."""
    outs = suite_runs("supercell suite + WSM6", device,
                      *supercell_setup(12, 16, "mp_wsm6"), 6)
    compare_scaled("supercell suite + WSM6",
                   {w: suite_fields(*o) for w, o in outs.items()}, PHYS_RTOL)


def check_small_sphere_suite(device, mesh8):
    """Phase 4: 3 f64 coupled steps of JW on the 642-cell sphere with six
    zero species, WSM6 and the suite, card vs CPU: the sphere's branches
    of cos_zenith, build_reconstruct_coeffs and reconstruct."""
    cfg, grid, state, diag = jw_setup(mesh8, 10, 1200.0, 960000.0,
                                      config_microp_scheme="mp_wsm6")
    state = dataclasses.replace(
        state, scalars=torch.zeros(state.scalars.shape[:2] + (6,),
                                   dtype=state.scalars.dtype))
    outs = suite_runs("JW sphere suite + WSM6", device, cfg, grid, state,
                      diag, 3)
    compare_scaled("JW sphere suite + WSM6",
                   {w: suite_fields(*o) for w, o in outs.items()}, PHYS_RTOL)


def check_small_convperm(device):
    """Phase 4: 6 f64 coupled steps of the supercell with eight species,
    Thompson and the convection_permitting suite from a Noah + MYNN
    physics state, at MESOREF_GMT, card vs CPU; rain reaches the ground
    and qke stays finite and >= 0."""
    outs = suite_runs("supercell convperm + Thompson", device,
                      *supercell_setup(12, 16, "mp_thompson"), 6,
                      pcfg="convection_permitting", init_kw=CONVPERM_INIT,
                      gmt_hours=MESOREF_GMT)
    fields = {w: suite_fields(*o) for w, o in outs.items()}
    for where, f in fields.items():
        require(np.isfinite(f["qke"]).all() and f["qke"].min() >= 0.0,
                f"qke on {where} not finite or negative")
        require(f["rainnc"].max() > 0.0, f"no rain on {where}")
    compare_scaled("supercell convperm + Thompson", fields, PHYS_RTOL)


def check_small_kf(device):
    """Phase 4: 6 f64 coupled steps of the supercell with WSM6 and the
    driver hook's default PhysicsConfig() (Kain-Fritsch) from a slab
    physics state, at MESOREF_GMT, card vs CPU."""
    outs = suite_runs("supercell Kain-Fritsch + WSM6", device,
                      *supercell_setup(12, 16, "mp_wsm6"), 6, pcfg=None,
                      init_kw={}, gmt_hours=MESOREF_GMT)
    compare_scaled("supercell Kain-Fritsch + WSM6",
                   {w: suite_fields(*o) for w, o in outs.items()}, PHYS_RTOL)


def check_small_cam(device):
    """Phase 4: 6 f64 coupled steps of the supercell with WSM6 and the
    mesoscale_reference suite under CAM radiation, with the supercell
    namelist's dissipation (2d_fixed, vertical eddy viscosities), at
    MESOREF_GMT, card vs CPU."""
    outs = suite_runs("supercell CAM suite + WSM6 + 2d_fixed", device,
                      *supercell_setup(12, 16, "mp_wsm6",
                                       **SUPERCELL_DISSIPATION), 6,
                      pcfg=cam_config(), gmt_hours=MESOREF_GMT)
    fields = {w: suite_fields(*o) for w, o in outs.items()}
    for where, f in fields.items():
        require(f["glw"].min() > 0.0, f"no downward longwave on {where}")
    compare_scaled("supercell CAM suite + WSM6 + 2d_fixed", fields,
                   PHYS_RTOL)


def check_small_jw_options(device, mesh8):
    """Phase 4: 3 f64 JW steps on the 642-cell sphere with Rayleigh
    damping of u and both vertical eddy viscosities, card vs CPU."""
    outs = atm_runs("JW rayleigh_damp_u + v_eddy_visc2", device,
                    *jw_setup(mesh8, 10, 1200.0, 960000.0,
                              config_rayleigh_damp_u=True,
                              config_v_mom_eddy_visc2=500.0,
                              config_v_theta_eddy_visc2=500.0), 3)
    compare_scaled("JW rayleigh_damp_u + v_eddy_visc2",
                   {w: state_fields(c) for w, c in outs.items()}, PHYS_RTOL)


def column_inputs(n, nz, seed):
    """Float64 columns from a seed (numpy): a 16-km sounding with random
    layer depths, latitudes, cloud water in 40% of the cells, a surface
    warmer or colder than the air, the sun up in 2/3 of the columns."""
    rng = np.random.default_rng(seed)
    dz = rng.uniform(250.0, 550.0, (n, nz))
    z_int = np.concatenate([np.zeros((n, 1)), np.cumsum(dz, 1)], 1)
    z = 0.5 * (z_int[:, 1:] + z_int[:, :-1])
    t = 300.0 - 0.0065 * z + 0.3 * rng.standard_normal((n, nz))
    p = 1.0e5 * np.exp(-z / 8000.0)
    qsat = 0.622 * 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65)) / p
    return dict(
        dz=dz, z_int=z_int, z=z, t=t, p=p, rho=p / (287.0 * t),
        qv=rng.uniform(0.3, 0.95, (n, nz)) * qsat,
        qc=np.where(rng.uniform(size=(n, nz)) < 0.4,
                    5e-4 * rng.uniform(size=(n, nz)), 0.0),
        tsk=t[:, 0] + rng.uniform(-5.0, 5.0, n),
        mu=np.where(np.arange(n) % 3 == 0, 0.0, rng.uniform(0.05, 1.0, n)),
        lat=rng.uniform(-1.5, 1.5, n),
        u=rng.uniform(-8.0, 14.0, (n, nz)), v=rng.uniform(-8.0, 8.0, (n, nz)))


def on_both(device, fn, arrays, names, **kw):
    """fn on float64 tensors of `arrays` on the CPU and on the card:
    {"cpu": {name: output as numpy}, "cuda": ...}; the outputs of a tuple
    take `names`, a dict's and a dataclass's their own."""
    outs = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        out = fn(*[torch.as_tensor(a, dtype=torch.float64, device=dev)
                   for a in arrays], **kw)
        flat = {}
        for name, o in zip(names, out if isinstance(out, tuple) else [out]):
            if isinstance(o, dict):
                flat.update(o)
            elif dataclasses.is_dataclass(o):
                flat.update({f.name: getattr(o, f.name)
                             for f in dataclasses.fields(o)})
            else:
                flat[name] = o
        outs[where] = {k: v.cpu().numpy() for k, v in flat.items()}
    return outs


def check_rrtmg_o3(device):
    """Phase 4: rrtmg_lw and rrtmg_sw with an o3_climatology profile on
    9,216 f64 columns of 40 levels, card vs CPU."""
    from mpas_tpu_torch.cores.atmosphere.physics import o3, rrtmg
    c = column_inputs(URBAN_CELLS, 40, 61)
    lw = on_both(device, lambda lat, p, *a: rrtmg.rrtmg_lw(
        *a, o3_vmr=o3.o3_climatology(lat, p)),
        [c[k] for k in ("lat", "p", "t", "qv", "qc", "rho", "dz", "tsk")],
        ("lw dtdt", "glw", "olr"))
    compare_scaled("rrtmg_lw with o3_climatology", lw, PHYS_RTOL)
    sw = on_both(device, lambda lat, p, *a: rrtmg.rrtmg_sw(
        *a, o3_vmr=o3.o3_climatology(lat, p)),
        [c[k] for k in ("lat", "p", "qv", "qc", "rho", "dz", "mu")],
        ("sw dtdt", "gsw"))
    compare_scaled("rrtmg_sw with o3_climatology", sw, PHYS_RTOL)


def check_urban_oml(device):
    """Phase 4: 10 chained slucm_step calls (the commercial URBPARM row,
    rain in a third of the columns, a solar azimuth), bep_column_drag,
    bep_heat_sources and oml_step on 9,216 f64 columns, card vs CPU."""
    from mpas_tpu_torch.cores.atmosphere.physics import oml, urban
    n = URBAN_CELLS
    c = column_inputs(n, 12, 62)
    rng = np.random.default_rng(63)
    forcing = [c["t"][:, 0], rng.uniform(0.2, 12.0, n),
               900.0 * c["mu"], rng.uniform(280.0, 420.0, n), c["mu"],
               c["qv"][:, 0], np.where(np.arange(n) % 3 == 1, 4.0, 0.0),
               rng.uniform(-np.pi, np.pi, n)]

    def slucm(*f):
        st = urban.init_urban_state(n, dtype=torch.float64,
                                    device=f[0].device)
        for _ in range(10):
            st, diag = urban.slucm_step(
                st, *f[:5], 60.0, hour_utc=15.5,
                params=urban.URBPARM_TABLE[3], qa=f[5], rain_mmh=f[6],
                sin_az=f[7])
        return st, diag
    compare_scaled("slucm_step x 10",
                   on_both(device, slucm, forcing, ("state", "diag")),
                   PHYS_RTOL)
    z_mid = 0.5 * (c["z_int"][:, 1:] + c["z_int"][:, :-1]) * 0.1
    compare_scaled("bep_column_drag", on_both(
        device, urban.bep_column_drag, [c["u"], c["v"], z_mid],
        ("bep u", "bep v", "bep tke"), dt=60.0,
        height_bins=(6.0, 12.0, 24.0, 40.0),
        height_fractions=(0.4, 0.3, 0.2, 0.1)), PHYS_RTOL)
    ts = [rng.uniform(285.0, 320.0, n) for _ in range(3)]
    compare_scaled("bep_heat_sources", on_both(
        device, urban.bep_heat_sources, [c["z_int"] * 0.1, *ts, c["t"]],
        ("bep heating",), uc=2.5), PHYS_RTOL)
    compare_scaled("oml_step", on_both(
        device, oml.oml_step,
        [rng.uniform(285.0, 302.0, n), rng.uniform(3.0, 80.0, n),
         rng.uniform(-50.0, 150.0, n), rng.uniform(0.0, 300.0, n),
         rng.uniform(0.0, 900.0, n), rng.uniform(300.0, 420.0, n),
         rng.uniform(0.0, 0.8, n)], ("tml", "h_ml"), dt=600.0), PHYS_RTOL)


def deep_unstable_columns(n, seed=41):
    """The deep unstable column of tests/test_atm_physics_suite.py:165-203
    on n columns (numpy, float64): 40 levels to 25 km (the scheme rejects
    clouds that would leave the lid), a dry adiabat below 800 m, 6.2 K/km
    to 16 km, then 2 K/km warming; 17 g/kg at the ground. Each column's
    temperature is shifted by up to +-0.3 K and its moisture scaled by
    0.97-1.03 from the seed. Returns kf_eta's (th, qv, p, rho, z, dz,
    exner)."""
    rng = np.random.default_rng(seed)
    zc = np.linspace(100.0, 25000.0, 40)
    zm = 800.0
    tt = np.where(zc < zm, 301.5 - 9.8e-3 * zc,
                  np.where(zc < 16000.0,
                           301.5 - 9.8e-3 * zm - 6.2e-3 * (zc - zm),
                           301.5 - 9.8e-3 * zm - 6.2e-3 * (16000.0 - zm)
                           + 2.0e-3 * (zc - 16000.0)))
    z = np.tile(zc, (n, 1))
    t = tt[None, :] + rng.uniform(-0.3, 0.3, (n, 1))
    p = 1.013e5 * np.exp(-z / 7600.0)
    exner = (p / 1.0e5) ** (287.0 / 1004.5)
    qv = 0.017 * rng.uniform(0.97, 1.03, (n, 1)) * np.exp(-z / 2500.0)
    return (t / exner, qv, p, p / (287.0 * t), z,
            np.tile(np.gradient(zc), (n, 1)), exner)


def check_kf_column(device):
    """Phase 4: kf_eta alone on 24 deep unstable columns (dt = 300 s), f64,
    card vs CPU: floating outputs at PHYS_RTOL x max, integer and boolean
    ones exactly; it fires (ainc > 0 and rain) in every column."""
    from mpas_tpu_torch.cores.atmosphere.physics.kfeta import kf_eta
    cols = deep_unstable_columns(24)
    outs = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        out = kf_eta(*[torch.from_numpy(a).to(dev) for a in cols], 300.0)
        outs[where] = {k: v.cpu().numpy() for k, v in out.items()}
        require((outs[where]["ainc"] > 0.0).all()
                and (outs[where]["raincv_m"] > 0.0).all(),
                f"kf_eta on {where} did not fire in every deep column")
    ints = {k for k, v in outs["cpu"].items()
            if not np.issubdtype(v.dtype, np.floating)}
    for k in sorted(ints):
        require(np.array_equal(outs["cuda"][k], outs["cpu"][k]),
                f"kf_eta {k}: the card's differs from the CPU's")
    print(f"  kf_eta deep columns: ainc {outs['cpu']['ainc'].min():.4f}-"
          f"{outs['cpu']['ainc'].max():.4f}, rain "
          f"{outs['cpu']['raincv_m'].min():.4e}-"
          f"{outs['cpu']['raincv_m'].max():.4e} m; {sorted(ints)} equal")
    compare_scaled("kf_eta deep columns",
                   {w: {k: v for k, v in o.items() if k not in ints}
                    for w, o in outs.items()}, PHYS_RTOL)


def check_small_supercell(device):
    """Phase 4: 6 f64 moist steps on the card vs the CPU."""
    outs = atm_runs("supercell", device, *supercell_setup(12, 16), 6)
    fields = {}
    for where, carry in outs.items():
        fields[where] = state_fields(carry)
        fields[where].update(rainnc=carry.rainnc.cpu().numpy(),
                             rt_diabatic_tend=carry.rt_diabatic_tend.cpu()
                             .numpy())
    require(float(fields["cpu"]["rainnc"].max()) > 0.0, "no rain reached "
            "the ground in the small supercell run")
    compare_scaled("supercell", fields)


def run_path(name, device, card, setup):
    """Phase 5, an atmosphere path at full size in float32 through the
    port's entry points: host setup, copy to the card, init_carry, one
    warm step, MAIN_STEPS timed steps; the launch counters are zeroed just
    before init_carry and read just after the last step."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.atmosphere.moisture import masses
    from mpas_tpu_torch.cores.atmosphere.physics import kessler
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, srk3_step)
    t0 = time.perf_counter()
    host = setup()
    cfg, grid, state, diag = host
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = grid.to(device, torch.float32)
    state = state.to(device, torch.float32)
    diag = diag.to(device, torch.float32)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nc, nz = grid.mesh.nCells, grid.vert.nz
    print(f"{name} setup: {nc} cells x {nz} levels, maxEdges "
          f"{grid.mesh.maxEdges}, {state.scalars.shape[-1]} scalar(s); host "
          f"build {host_s:.2f} s, copy to card {copy_s:.2f} s")

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
    for k in STATE_FIELDS:
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
    return cfg, grid, carry, counts, drift, sed, host, ms


def run_supercell_path(device, card):
    """Phase 5, supercell_2km (bench.py:104-119) in float32, from the
    seeded moist start: the timed steps carry cloud and rain."""
    cfg, grid, carry, counts, drift, sed, _, _ = run_path(
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


def kernel_census(fn, module=None, regions=(), spans=()):
    """(fn(), kernels, device busy ms) of one call of fn under
    torch.profiler: every kernel the call launched and the sum of their
    device times. With `regions`, functions of `module` wrapped in a
    record_function span for the call, and `spans`, names of spans fn
    opens itself: a fourth item maps each to the device ms of the kernels
    it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(region, f):
        def call(*args, **kwargs):
            with record_function(region):
                return f(*args, **kwargs)
        return call
    saved = [(n, getattr(module, n)) for n in regions]
    torch.cuda.synchronize()
    try:
        for n, f in saved:
            setattr(module, n, spanned(n, f))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved:
            setattr(module, n, f)
    regions = tuple(regions) + tuple(spans)
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.key not in regions]
    census = (out, sum(e.count for e in kern),
              sum(e.self_device_time_total for e in kern) / 1e3)
    if not regions:
        return census
    return census + ({e.key: e.device_time_total / 1e3 for e in events
                      if e.key in regions
                      and e.device_type == DeviceType.CPU},)


def run_physics_path(device, card, name, scheme, pcfg, init_kw,
                     cfg_kw=None, regions=None):
    """Phase 5, supercell_2km (bench.py:104-119) with `scheme`
    microphysics and a physics suite (`pcfg`, None for PhysicsConfig())
    before every dynamics step, in float32, at MESOREF_GMT, through
    run_steps_with_physics one step at a time: host setup (grid, seeded
    state, reconstruction coefficients), copy to the card, init_carry, one
    warm step (radiation is due in it, timed on its own), MAIN_STEPS timed
    steps; the launch counters are zeroed just before init_carry and read
    after every step. Then one step under the profiler for the kernels and
    device busy ms a step. Gates: 12 K1 and K2_PER_STEP[name] K2 every
    step, finite fields, dry mass, species >= 0. cfg_kw goes to AtmConfig;
    regions = (module, names): the profiled step also reports the device
    ms of each named function's kernels. Returns a dict of the run (cfg,
    grid, carry, phys, coeffs, pcfg, counts, step, ms, peak_gb)."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
    from mpas_tpu_torch.cores.atmosphere.moisture import (RHO_WATER,
                                                          masses)
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        SCHEME_FIELDS, PhysicsConfig, init_physics_state)
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs
    f32 = torch.float32
    t0 = time.perf_counter()
    cfg, grid, state, diag = supercell_setup(96, 40, scheme,
                                             **(cfg_kw or {}))
    coeffs = build_reconstruct_coeffs(grid.mesh)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid, state, diag = (grid.to(device, f32), state.to(device, f32),
                         diag.to(device, f32))
    coeffs = torch.from_numpy(coeffs).to(device, f32)
    nc, nz = grid.mesh.nCells, grid.vert.nz
    phys = init_physics_state(nc, nz, dtype=f32, device=device, **init_kw)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nsc = state.scalars.shape[-1]
    schemes = ", ".join(getattr(pcfg or PhysicsConfig(), k)
                        for k in SCHEME_FIELDS)
    print(f"{name} setup: {nc} cells x {nz} levels, {nsc} scalars, "
          f"{scheme}, physics {schemes}; host build {host_s:.2f} s "
          f"(reconstruction coefficients included), copy to card "
          f"{copy_s:.2f} s")
    require((nc, nz, nsc) == (9216, 40, 8 if scheme == "mp_thompson" else 6),
            f"{name} built the wrong size")

    dt = cfg.config_dt

    def step(carry, phys):
        return run_steps_with_physics(grid, cfg, carry, phys, coeffs, dt, 1,
                                      pcfg=pcfg, gmt_hours=MESOREF_GMT)
    per_step = {"acoustic_cell_update": K1_PER_STEP,
                "tinydot": K2_PER_STEP[name]}
    kernels.reset_launch_counts()
    carry = init_carry(grid, cfg, state, diag, dt)
    mass0 = masses(grid, carry)
    seen = [dict(kernels.launch_counts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, phys = step(carry, phys)                          # warm step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    seen.append(dict(kernels.launch_counts))
    glw_min = float(phys.glw.min())
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        carry, phys = step(carry, phys)
        seen.append(dict(kernels.launch_counts))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = seen[-1]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    for kname, n in per_step.items():
        got = [b[kname] - a[kname] for a, b in zip(seen, seen[1:])]
        require(got == [n] * (MAIN_STEPS + 1),
                f"{name}: {kname} launches per step {got}, expected {n}")
    for k in STATE_FIELDS:
        require(bool(torch.isfinite(getattr(carry.state, k)).all()), k)
    require(bool(torch.isfinite(carry.rainnc).all()), "rainnc not finite")
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        require(v is None or bool(torch.isfinite(v).all()),
                f"physics state {f.name} not finite")
    mass1 = masses(grid, carry)
    drift = abs(mass1[0] - mass0[0]) / mass0[0]
    sc = carry.state.scalars
    area = grid.mesh.areaCell.double()
    rain_kg = [float((r.double() * RHO_WATER * area).sum())
               for r in (carry.rainnc, phys.rainc)]
    species = ("qv", "qc", "qr", "qi", "qs", "qg", "nr", "ni")[:nsc]
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {ms:.2f} ms/step, {nc * MAIN_STEPS / elapsed:.1f} cell-column "
          f"updates/s; peak device memory {peak_gb:.2f} GB; radiation-due "
          f"warm step {warm_s:.3f} s; dry-mass drift {drift:.3e}; launches "
          f"{counts} (per step: K1 {per_step['acoustic_cell_update']}, K2 "
          f"{per_step['tinydot']})")
    print(f"{name} after {MAIN_STEPS + 1} steps: max w "
          f"{float(carry.state.w.max()):.4f} m/s; "
          + ", ".join(f"max {q} {float(sc[..., i].max()):.4e}"
                      for i, q in enumerate(species[1:], 1))
          + f"; total water {mass1[1] - mass0[1]:+.6e} kg (rainnc "
          f"{rain_kg[0]:.6e} kg in the budget, rainc {rain_kg[1]:.6e} kg "
          f"outside it; a budget, not an invariant: surface evaporation "
          f"and convective rain); tsk std {float(phys.tsk.std()):.4e} K, "
          f"min glw after the warm step {glw_min:.3f} W/m2")
    require(drift <= 1e-5, f"{name}: dry mass not conserved: {drift:.3e}")
    require(float(sc[..., :6].min()) >= 0.0, f"{name}: a negative species")
    census = kernel_census(lambda: step(carry, phys), *(regions or ()))
    n_kern, busy = census[1:3]
    print(f"{name} one profiled step on {card}: {n_kern} kernels, device "
          f"busy {busy:.3f} ms ({100.0 * (1.0 - busy / ms):.1f}% idle "
          f"against the timed {ms:.2f} ms/step)"
          + "".join(f"; {k} {v:.3f} ms" for k, v in
                    (census[3].items() if regions else ())))
    return dict(cfg=cfg, grid=grid, carry=carry, phys=phys, coeffs=coeffs,
                pcfg=pcfg, counts=counts, step=step, glw_min=glw_min, ms=ms,
                peak_gb=peak_gb)


def run_mesoref_path(device, card):
    """Phase 5, supercell_2km_mesoref: supercell_2km with WSM6 and the
    mesoscale_reference suite in place of Kessler alone; rain reaches the
    ground, the skin temperature moves and the warm step's radiation
    leaves downward longwave."""
    name = "supercell_2km_mesoref"
    run = run_physics_path(device, card, name, "mp_wsm6",
                           suite_config("mesoscale_reference"),
                           MESOREF_INIT)
    carry, phys = run["carry"], run["phys"]
    require(float(carry.rainnc.max()) > 0.0, f"{name}: no rain reached "
            "the ground")
    require(float(phys.tsk.std()) > 0.0, f"{name}: tsk did not move")
    require(run["glw_min"] > 0.0, f"{name}: no downward longwave after the "
            "radiation call")
    return run


def run_cam_path(device, card):
    """Phase 5, supercell_2km_cam: supercell_2km_mesoref with CAM
    radiation in place of RRTMG and the supercell namelist's dissipation
    (2d_fixed, horizontal and vertical eddy viscosities of 500 m^2/s, no
    del4); the same gates, and cam_lw's and cam_sw's device ms in the
    profiled step."""
    from mpas_tpu_torch.cores.atmosphere.physics import cam_radiation
    name = "supercell_2km_cam"
    run = run_physics_path(device, card, name, "mp_wsm6", cam_config(),
                           MESOREF_INIT, cfg_kw=SUPERCELL_DISSIPATION,
                           regions=(cam_radiation, ("cam_lw", "cam_sw")))
    carry, phys = run["carry"], run["phys"]
    cfg = run["cfg"]
    require((cfg.config_horiz_mixing, cfg.config_v_mom_eddy_visc2,
             cfg.config_v_theta_eddy_visc2)
            == ("2d_fixed", 500.0, 500.0), f"{name}: not the namelist's "
            "dissipation")
    require(float(carry.rainnc.max()) > 0.0, f"{name}: no rain reached "
            "the ground")
    require(float(phys.tsk.std()) > 0.0, f"{name}: tsk did not move")
    require(run["glw_min"] > 0.0, f"{name}: no downward longwave after the "
            "radiation call")
    print(f"{name}: max rainnc {float(carry.rainnc.max()):.4e} m, tsk in "
          f"[{float(phys.tsk.min()):.3f}, {float(phys.tsk.max()):.3f}] K, "
          f"gsw in [{float(phys.gsw.min()):.3f}, "
          f"{float(phys.gsw.max()):.3f}] W/m2")
    return run


DIAG_NAMES = ("isobaric", "convective", "pv", "reflectivity")


def check_diagnostics(label, device, grid, state, diag, names):
    """Phase 5d: the diagnostics manager's `names` on a path's final f32
    state: once in f32 on the card (timed), then in f64 from that state on
    the card and on the CPU, held at PHYS_RTOL x max with the same NaN
    positions."""
    from mpas_tpu_torch.cores.atmosphere.diagnostics.manager import (
        DiagnosticsManager)

    def run(dev, dtype):
        g, s, d = grid.to(dev, dtype), state.to(dev, dtype), \
            diag.to(dev, dtype)
        dm = DiagnosticsManager({n: 3600.0 for n in names})
        dm.init()
        t0 = time.perf_counter()
        dm.compute_all(g, g.mesh, s, d)
        return dm.history, time.perf_counter() - t0
    _, f32_s = run(device, torch.float32)
    hist = {w: run(dev, torch.float64)[0]
            for w, dev in (("cpu", torch.device("cpu")), ("cuda", device))}
    for n in names:
        ref, got = hist["cpu"][n][0][1], hist["cuda"][n][0][1]
        require(sorted(ref) == sorted(got), n)
        for k in ref:
            nan = np.isnan(ref[k])
            require(np.array_equal(nan, np.isnan(got[k])),
                    f"{label} {n}.{k}: NaN positions differ")
            fin = ~nan
            scale = float(np.abs(ref[k][fin]).max()) if fin.any() else 0.0
            err = float(np.abs(got[k][fin] - ref[k][fin]).max()) \
                if fin.any() else 0.0
            print(f"  {label} {n}.{k} {ref[k].shape}: cuda vs cpu max abs "
                  f"err {err:.3e} (max|cpu| {scale:.3e}); "
                  f"{int(nan.sum())} NaN")
            require(err <= PHYS_RTOL * scale,
                    f"{label} {n}.{k}: the card departs from the CPU")
    print(f"{label} diagnostics {', '.join(names)}: f32 on the card "
          f"{f32_s:.3f} s (host copies included)")


def run_convperm_path(device, card):
    """Phase 5, supercell_2km_convperm: supercell_2km with Thompson, eight
    species and the convection_permitting suite from a Noah + MYNN
    physics state; nr and ni stay in [1e-2, 1e8], qke finite and >= 0,
    rain reaches the ground."""
    name = "supercell_2km_convperm"
    run = run_physics_path(device, card, name, "mp_thompson",
                           suite_config("convection_permitting"),
                           CONVPERM_INIT)
    carry, phys = run["carry"], run["phys"]
    num = carry.state.scalars[..., 6:]
    print(f"{name}: nr, ni in [{float(num.min()):.4e}, "
          f"{float(num.max()):.4e}] /kg; qke in [{float(phys.qke.min()):.4e},"
          f" {float(phys.qke.max()):.4e}] m2/s2; max rainnc "
          f"{float(carry.rainnc.max()):.4e} m, max rainc "
          f"{float(phys.rainc.max()):.4e} m")
    # the bounds as the state's float32 holds them
    lo, hi = (float(torch.tensor(b, dtype=num.dtype)) for b in (1e-2, 1e8))
    require(float(num.min()) >= lo and float(num.max()) <= hi,
            f"{name}: nr or ni left [1e-2, 1e8]")
    require(bool(torch.isfinite(phys.qke).all())
            and float(phys.qke.min()) >= 0.0, f"{name}: qke")
    require(float(carry.rainnc.max()) > 0.0, f"{name}: no rain reached "
            "the ground")
    return run


def run_kf_path(device, card):
    """Phase 5, supercell_2km_kf: supercell_2km_mesoref's grid and start
    (WSM6, six species) with the driver hook's default PhysicsConfig()
    (Kain-Fritsch, YSU, MM5 surface layer, slab LSM, broadband radiation)
    from a slab physics state. Prints the columns Kain-Fritsch activates
    on the state after the timed steps, the largest rainc, and kf_eta's
    kernels and device ms a call (one call on inputs derived from that
    state as physics_step derives them, profiled alone)."""
    from mpas_tpu_torch.cores.atmosphere.physics import kfeta
    from mpas_tpu_torch.tools.op_count import kf_eta_inputs
    name = "supercell_2km_kf"
    run = run_physics_path(device, card, name, "mp_wsm6", None, {})
    carry = run["carry"]
    args, kwargs = kf_eta_inputs(run["grid"], carry.state, carry.diag,
                                 run["coeffs"])
    out, n_kern, busy = kernel_census(
        lambda: kfeta.kf_eta(*args, run["cfg"].config_dt, **kwargs))
    active = int((out["ainc"] > 0.0).sum())
    print(f"{name}: Kain-Fritsch active in {active} of "
          f"{out['ainc'].shape[0]} columns ({int(out['ishall'].sum())} "
          f"shallow) on the state after the timed steps; max rainc "
          f"{float(run['phys'].rainc.max()):.4e} m after "
          f"{MAIN_STEPS + 1} steps; kf_eta alone on {card}: {n_kern} "
          f"kernels, device busy {busy:.3f} ms a call")
    return run


def run_sw_path(device, card, mesh):
    """Phase 5, sw_tc5_120km (bench.py:160-181): shallow-water test case 5
    on the 40,962-cell mesh, dt = 45 s, RK4 with the fused stage and two
    tracers, in float32: host setup, copy to the card, one warm step,
    MAIN_STEPS timed steps; the launch counters are zeroed just before the
    warm step and read just after the last step."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.sw import test_cases
    from mpas_tpu_torch.cores.sw.config import SWConfig
    from mpas_tpu_torch.cores.sw.global_diagnostics import global_diagnostics
    from mpas_tpu_torch.cores.sw.time_integration import rk4_step
    name = "sw_tc5_120km"
    t0 = time.perf_counter()
    mesh, state, h_s = test_cases.test_case_5(mesh)
    cfg = SWConfig(config_dt=45.0, config_test_case=5)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32 = torch.float32
    mesh, state, h_s = (mesh.to(device, f32), state.to(device, f32),
                        h_s.to(device, f32))
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nc, dt = mesh.nCells, cfg.config_dt
    print(f"{name} setup: {nc} cells, {state.tracers.shape[-1]} tracers; "
          f"host build {host_s:.2f} s, copy to card {copy_s:.2f} s")
    require(nc == 40962, f"{name} built the wrong size")

    diag0 = global_diagnostics(mesh, state, h_s, dt)
    area = mesh.areaCell.double()[:, None]
    tracer0 = (state.tracers.double() * state.h.double()[:, None]
               * area).sum(0)
    kernels.reset_launch_counts()
    state = rk4_step(mesh, cfg, state, h_s, dt)               # warm step
    torch.cuda.synchronize()
    before = dict(kernels.launch_counts)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        state = rk4_step(mesh, cfg, state, h_s, dt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    steps = MAIN_STEPS + 1
    require(counts["acoustic_cell_update"] == 0, counts)
    require(counts["tinydot"] == SW_K2_PER_STEP * steps, counts)
    require(counts["tinydot"] - before["tinydot"]
            == SW_K2_PER_STEP * MAIN_STEPS, counts)
    for k in ("u", "h", "tracers"):
        require(bool(torch.isfinite(getattr(state, k)).all()), k)
    require(bool((state.h > 0.0).all()), "non-positive thickness")
    diag1 = global_diagnostics(mesh, state, h_s, dt)
    drift = abs(diag1["total_mass"] - diag0["total_mass"]) \
        / diag0["total_mass"]
    tracer1 = (state.tracers.double() * state.h.double()[:, None]
               * area).sum(0)
    tracer_drift = float(((tracer1 - tracer0).abs() / tracer0.abs()).max())
    energy = (diag1["total_energy"] - diag0["total_energy"]) \
        / diag0["total_energy"]
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {ms:.2f} ms/step, {nc * MAIN_STEPS / elapsed:.1f} cell-column "
          f"updates/s; peak device memory {peak_gb:.2f} GB; mass (h x area) "
          f"drift {drift:.3e}, tracer-mass drift {tracer_drift:.3e}, energy "
          f"change {energy:.3e}, max CFL {diag1['max_cfl']:.4f}; launches "
          f"{counts} (per step: K1 0, K2 {SW_K2_PER_STEP})")
    require(drift <= 1e-5, f"h x area not conserved: {drift:.3e}")
    require(tracer_drift <= 1e-5, f"tracer mass not conserved: "
            f"{tracer_drift:.3e}")
    return cfg, mesh, state, h_s, counts


def run_var_path(device, card):
    """Phase 5, jw_var60_15 (bench.py:67-77): JW case 2 on
    variable_res_mesh(23000, iterations=30), 26 levels, dt = 90 s,
    config_len_disp = 15 km, a quarter of the Earth's radius, mesh-scaled
    dissipation, in float32."""
    cfg, grid, carry, counts, _, _, _, _ = run_path(
        "jw_var60_15", device, card,
        lambda: jw_var_setup(23000, 30, 26, 90.0, 15000.0))
    mesh = grid.mesh
    require((mesh.nCells, grid.vert.nz, mesh.maxEdges) == (23000, 26, 8),
            "jw_var60_15 built the wrong size")
    scale = mesh.meshScalingDel2
    print(f"jw_var60_15 mesh: {mesh.nEdges} edges, {mesh.nVertices} "
          f"vertices, vertexDegree {mesh.vertexDegree}, meshScalingDel2 "
          f"{float(scale.min()):.4f}-{float(scale.max()):.4f}, dcEdge "
          f"{float(mesh.dcEdge.min()) / 1e3:.2f}-"
          f"{float(mesh.dcEdge.max()) / 1e3:.2f} km")
    require(float(scale.max()) > 3.9, "mesh scaling not applied")
    return cfg, grid, carry, counts


# the real-data paths: a seeded first guess on a global lat-lon grid
GFS_LEVELS_HPA = (1000, 975, 950, 925, 900, 850, 800, 750, 700, 650, 600,
                  550, 500, 450, 400, 350, 300, 250, 200, 150, 100, 70, 50,
                  30, 20, 10)          # GFS's 26 isobaric levels
REAL_NZ, REAL_ZT = 55, 30000.0       # namelist.init_atmosphere defaults
# qv >= 0 holds exactly in float64 (phase 4, tests/test_torch_real_slice.py);
# in float32 the flux-form update of levels where qv is 0 leaves rounding
# of a few 1e-16 below it: the f32 path is held to -eps32 x max qv
QV_F32_FLOOR = float(np.finfo(np.float32).eps)


def _smooth(rng, lat, lon, modes=6):
    """A seeded smooth field on the lat-lon grid, |.| <= 1, zero at the
    poles: a few low-wavenumber waves."""
    out = np.zeros_like(lat)
    for _ in range(modes):
        m, k = rng.integers(1, 6), rng.integers(1, 5)
        p1, p2 = rng.uniform(0.0, 2.0 * np.pi, 2)
        out += np.cos(m * lon + p1) * np.cos(k * lat + p2)
    return np.cos(lat) * out / max(float(np.abs(out).max()), 1e-30)


def write_first_guess(path, seed, dlat):
    """A GFS-like first guess on a global (360/dlat) x (180/dlat + 1)
    lat-lon grid, written with the port's write_met_file: the analytic
    profiles of tests/test_init_real.py (_synthetic_gfs) on GFS's 26
    levels, with seeded smooth perturbations (about 1 K, 1 m/s and 5%
    RH); PSFC, SKINTEMP and SOILHGT (200 m cos(lat) plus seeded Gaussian
    hills up to 1,500 m, e-folding 1,000 km, PSFC reduced over them with
    the profile's scale height); and the soil, SST, SEAICE and SNOW group
    of _synthetic_gfs_full. Returns the fields as written."""
    from mpas_tpu_torch.cores.init_atmosphere import met_reader as mr
    rng = np.random.default_rng(seed)
    ny, nx = int(round(180.0 / dlat)) + 1, int(round(360.0 / dlat))
    lats = -90.0 + dlat * np.arange(ny)
    lons = dlat * np.arange(nx)
    LA, LO = np.meshgrid(lats, lons, indexing="ij")
    la, lo = np.radians(LA), np.radians(LO)
    coslat = np.cos(la)
    meta = dict(hdate="2020-01-01_00:00:00", xfcst=0.0, nx=nx, ny=ny,
                iproj=0, startlat=float(lats[0]), startlon=float(lons[0]),
                deltalat=dlat, deltalon=dlat, earth_radius=6371.229,
                is_wind_grid_rel=False)
    fields = []

    def add(name, units, xlvl, slab):
        fields.append(mr.MetField(field=name, units=units, desc=name,
                                  xlvl=float(xlvl), slab=slab, **meta))

    pert = {k: (_smooth(rng, la, lo), _smooth(rng, la, lo))
            for k in ("TT", "UU", "VV", "RH")}
    amp = {"TT": 1.0, "UU": 1.0, "VV": 1.0, "RH": 5.0}
    scale_h = 287.0 * 250.0 / 9.81 * (1.0 + 0.01 * coslat)
    for hpa in GFS_LEVELS_HPA:
        p = 100.0 * hpa
        s = np.log(101325.0 / p) / np.log(101325.0 / 1e3)   # 0 .. 1

        def pt(k):
            return amp[k] * ((1.0 - s) * pert[k][0] + s * pert[k][1])
        t = 288.0 - 55.0 * np.log(101325.0 / p) / np.log(101325.0 / 1e4) \
            + 10.0 * coslat + pt("TT")
        z = scale_h * np.log(101325.0 / p)
        u = 20.0 * np.sin(2.0 * la) ** 2 * (p / 1e5) + pt("UU")
        v = pt("VV")
        rh = np.clip(50.0 * (p / 1e5) + pt("RH"), 0.0, 100.0)
        for name, slab, units in (("TT", t, "K"), ("GHT", z, "m"),
                                  ("UU", u, "m s-1"), ("VV", v, "m s-1"),
                                  ("RH", rh, "%")):
            add(name, units, p, slab)
    hills = np.zeros_like(LA)
    for _ in range(6):
        clat = np.radians(rng.uniform(-60.0, 60.0))
        clon = np.radians(rng.uniform(0.0, 360.0))
        d = 6371.229e3 * np.arccos(np.clip(
            np.sin(la) * np.sin(clat)
            + coslat * np.cos(clat) * np.cos(lo - clon), -1.0, 1.0))
        hills += rng.uniform(500.0, 1500.0) * np.exp(-(d / 1.0e6) ** 2)
    ter = 200.0 * np.maximum(coslat, 0.0) + hills
    sfc = {
        "PSFC": (101325.0 - 500.0 * coslat) * np.exp(-ter / scale_h),
        "SKINTEMP": 288.0 + 12.0 * coslat,
        "SOILHGT": ter,
        "ST000010": 285.0 + 10.0 * coslat,
        "ST010040": 284.0 + 9.0 * coslat,
        "ST040100": 283.0 + 8.0 * coslat,
        "ST100200": 282.0 + 7.0 * coslat,
        "SM000010": 0.25 + 0.1 * np.sin(lo),
        "SM010040": 0.27 + 0.1 * np.sin(lo),
        "SM040100": 0.30 + 0.05 * np.sin(lo),
        "SM100200": 0.32 + 0.02 * np.sin(lo),
        "SST": 271.0 + 29.0 * coslat ** 2,
        "SEAICE": np.where(np.abs(LA) > 70.0, 0.9, 0.0),
        "SNOW": np.where(np.abs(LA) > 60.0, 5.0, 0.0),
    }
    for name, slab in sfc.items():
        add(name, "-", 200100.0, np.asarray(slab, dtype=np.float64))
    mr.write_met_file(path, fields)
    return fields


def real_config(nz, dt, len_disp):
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    return AtmConfig(config_nvertlevels=nz, config_dt=dt,
                     config_len_disp=len_disp)


def check_small_real(device, mesh8):
    """Phase 4: the real-data init (a seeded 5-degree first guess) on the
    642-cell sphere, 10 levels, and 3 f64 steps on the card vs the CPU at
    1e-11 x max."""
    from mpas_tpu_torch.cores.init_atmosphere import met_reader as mr
    from mpas_tpu_torch.cores.init_atmosphere.real_case import init_real
    cfg = real_config(10, 1200.0, 960000.0)
    with tempfile.TemporaryDirectory(prefix="real_small") as tmp:
        path = os.path.join(tmp, "FILE:2020-01-01_00")
        write_first_guess(path, 0, 5.0)
        grid, state, diag, _ = init_real(mesh8, cfg, mr.read_met_file(path))
    outs = atm_runs("real-data", device, cfg, grid, state, diag, 3)
    compare_scaled("real-data", {w: state_fields(c) for w, c in outs.items()},
                   rel=PHYS_RTOL)
    for where, c in outs.items():
        require(float(c.state.scalars[..., 0].min()) >= 0.0,
                f"real-data f64 on {where}: negative qv")


REGIONAL_MESH = (96, 96, 3000.0)     # box_hex_mesh: 8,836 cells


def check_regional_iau(device):
    """Phase 4: the regional zones and IAU at full size, f64, card vs
    CPU at 1e-11 x max: build_bdy_masks on box_hex_mesh(96, 96, 3 km),
    relaxzone_tend and speczone_reset on cells, edges and a 3-D scalar
    field at 55 levels, lbc_interp of an LbcRecord inside and at both
    ends of its interval, and iau_tendencies inside and after the
    window."""
    from mpas_tpu_torch.cores.atmosphere import boundaries as bdy
    from mpas_tpu_torch.cores.atmosphere import iau
    from mpas_tpu_torch.cores.init_atmosphere.surface_lbc import LbcRecord
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    t0 = time.perf_counter()
    mesh = box_hex_mesh(*REGIONAL_MESH)
    masks = bdy.build_bdy_masks(mesh)
    print(f"regional box mesh {mesh.nCells} cells, {mesh.nEdges} edges and "
          f"its zones in {time.perf_counter() - t0:.2f} s; cells per zone "
          f"{np.bincount(masks.bdyMaskCell.numpy()).tolist()}")
    rng = np.random.default_rng(0)
    nc, ne, nz = mesh.nCells, mesh.nEdges, REAL_NZ

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    def rec(time_s):
        return LbcRecord(time=time_s, lbc_u=arr(ne, nz),
                         lbc_theta=300.0 + arr(nc, nz),
                         lbc_rho=1.0 + 0.01 * arr(nc, nz),
                         lbc_w=arr(nc, nz + 1), lbc_scalars=arr(nc, nz, 2))
    lbc = (rec("t1"), rec("t2"))
    field = {"cell": arr(nc, nz), "edge": arr(ne, nz),
             "scalars": arr(nc, nz, 2)}
    inc = iau.IAUIncrements(theta_incr=arr(nc, nz),
                            rho_incr=1e-3 * arr(nc, nz),
                            u_incr=arr(ne, nz), qv_incr=1e-4 * arr(nc, nz))
    rho = 1.0 + 0.1 * arr(nc, nz).abs()
    cfg = iau.IAUConfig("on", 21600.0)

    def ops(dev):
        m = masks.to(dev, torch.float64)
        f = {k: v.to(dev) for k, v in field.items()}
        drive = {"cell": lbc[0].lbc_theta.to(dev),
                 "edge": lbc[0].lbc_u.to(dev),
                 "scalars": lbc[0].lbc_scalars.to(dev)}
        out = {}
        for k in f:
            on_edges = k == "edge"
            out[f"relax_{k}"] = bdy.relaxzone_tend(m, 720.0, f[k], drive[k],
                                                   on_edges)
            out[f"spec_{k}"] = bdy.speczone_reset(m, f[k], drive[k],
                                                  on_edges)
        moved = [dataclasses.replace(r, **{
            n: getattr(r, n).to(dev) for n in ("lbc_u", "lbc_theta",
                                               "lbc_rho", "lbc_w",
                                               "lbc_scalars")}) for r in lbc]
        for now in (0.0, 7200.0, 21600.0):
            mid = bdy.lbc_interp(moved[0], moved[1], 0.0, 21600.0, now)
            for n in ("lbc_u", "lbc_theta", "lbc_w", "lbc_scalars"):
                out[f"lbc_interp_{n}_{now:g}"] = getattr(mid, n)
        i = inc.to(dev, torch.float64)
        for el in (3600.0, 21600.0):
            tends = iau.iau_tendencies(cfg, i, rho.to(dev), el)
            for n, t in zip(("rtheta", "rho", "u", "qv"), tends):
                out[f"iau_{n}_{el:g}"] = t
        return {k: v.cpu().numpy() for k, v in out.items()}

    got, ref = ops(device), ops(torch.device("cpu"))
    worst = 0.0
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(got[k] - r).max())
        worst = max(worst, err / scale if scale else err)
        require(np.isfinite(got[k]).all() and err <= PHYS_RTOL * scale,
                f"regional {k}: card {err:.3e} from the CPU (max {scale:.3e})")
        if k.startswith("iau_") and k.endswith("21600"):
            require(scale == 0.0, f"{k}: IAU active after its window")
    print(f"regional zones, LBC interpolation and IAU on the card: "
          f"{len(ref)} outputs, worst err / max|cpu| {worst:.3e} (bound "
          f"{PHYS_RTOL:g})")


def check_grid_file(mesh, read):
    """The mesh read from its grid file against the mesh it was written
    from, array by array, bit for bit; edgesOnEdge and weightsOnEdge in
    the file's packed layout."""
    from mpas_tpu_torch.mesh.gridfile import packed_edges_on_edge
    eoe, woe, _ = packed_edges_on_edge(mesh)
    packed = {"edgesOnEdge": eoe, "weightsOnEdge": woe}
    n = 0
    for f in dataclasses.fields(mesh):
        a, b = getattr(mesh, f.name), getattr(read, f.name)
        if isinstance(a, torch.Tensor):
            want = packed.get(f.name, a.numpy())
            require(b.dtype == a.dtype and np.array_equal(b.numpy(), want),
                    f"grid file: {f.name} differs from the written mesh")
            n += 1
        else:
            require(a == b, f"grid file: {f.name} {a} != {b}")
    return n


def real_setup(mesh, grid_dir, seed, timings):
    """real_120km's host setup: the mesh through its netCDF4 grid file,
    the first guess through its WPS intermediate file, then init_real.
    Fills `timings` with the host seconds of each part."""
    from mpas_tpu_torch.cores.init_atmosphere import met_reader as mr
    from mpas_tpu_torch.cores.init_atmosphere.real_case import init_real
    from mpas_tpu_torch.mesh.gridfile import mesh_from_netcdf, mesh_to_netcdf
    grid_path = os.path.join(grid_dir, "x1.40962.grid.nc")
    t0 = time.perf_counter()
    mesh_to_netcdf(mesh, grid_path, fmt="netcdf4")
    t1 = time.perf_counter()
    read = mesh_from_netcdf(grid_path)
    t2 = time.perf_counter()
    n = check_grid_file(mesh, read)
    with open(grid_path, "rb") as fh:
        require(fh.read(4) == b"\x89HDF", "the grid file is not netCDF4")
    met_path = os.path.join(grid_dir, "FILE:2020-01-01_00")
    t3 = time.perf_counter()
    written = write_first_guess(met_path, seed, 0.5)
    t4 = time.perf_counter()
    fields = mr.read_met_file(met_path)
    t5 = time.perf_counter()
    require(len(fields) == len(written) and all(
        a.field == b.field and a.xlvl == b.xlvl and np.array_equal(
            a.slab, b.slab.astype(np.float32)) for a, b in
        zip(fields, written)), "the met file does not read back as written")
    cfg = real_config(REAL_NZ, 720.0, 120000.0)
    grid, state, diag, extras = init_real(read, cfg, fields, zt=REAL_ZT,
                                          timings=timings)
    t6 = time.perf_counter()
    timings.update(grid_write_s=t1 - t0, grid_read_s=t2 - t1,
                   met_write_s=t4 - t3, met_read_s=t5 - t4,
                   init_real_s=t6 - t5, grid_path=grid_path)
    print(f"real_120km grid file {os.path.getsize(grid_path) / 1e6:.1f} MB "
          f"(netCDF4), {n} arrays bit for bit with the generated mesh; "
          f"first guess {len(fields)} fields of {fields[0].nx} x "
          f"{fields[0].ny} ({os.path.getsize(met_path) / 1e6:.1f} MB); "
          f"terrain {float(extras['ter'].min()):.0f}-"
          f"{float(extras['ter'].max()):.0f} m")
    os.remove(met_path)
    return cfg, grid, state, diag


def run_real_path(device, card, mesh, grid_dir, seed):
    """Phase 5, real_120km: the real-data atmosphere on the 40,962-cell
    mesh read back from its netCDF4 grid file, 55 levels to 30 km, dt =
    720 s, float32: init_real from the seeded 0.5-degree first guess,
    then run_path (12 K1 and 15 K2 a step); dry mass and total qv
    conserved to 1e-5, qv >= 0 to float32 rounding (QV_F32_FLOOR), max
    |u| < 150 m/s."""
    timings = {}
    cfg, grid, carry, counts, drift, _, _, ms = run_path(
        "real_120km", device, card,
        lambda: real_setup(mesh, grid_dir, seed, timings))
    require((grid.mesh.nCells, grid.vert.nz) == (40962, REAL_NZ),
            "real_120km built the wrong size")
    qv = carry.state.scalars[..., 0]
    qv_min, qv_max = float(qv.min()), float(qv.max())
    n_neg = int((qv < 0).sum())
    u_max = float(carry.state.u.abs().max())
    print(f"real_120km host seconds on {card}: grid file write "
          f"{timings['grid_write_s']:.2f}, read {timings['grid_read_s']:.2f}; "
          f"met file write {timings['met_write_s']:.2f}, read "
          f"{timings['met_read_s']:.2f}; init_real "
          f"{timings['init_real_s']:.2f} (vertical_interp "
          f"{timings['vertical_interp_s']:.2f}); total-qv drift "
          f"{drift[1]:.3e}; qv {qv_min:.3e} to {qv_max:.3e} ({n_neg} values "
          f"below 0); max |u| {u_max:.2f} m/s; "
          f"{ms:.2f} ms/step")
    require(drift[1] <= 1e-5, f"total qv not conserved: {drift[1]:.3e}")
    require(qv_min >= -QV_F32_FLOOR * qv_max, f"negative qv {qv_min:.3e}")
    require(u_max < 150.0, f"max |u| {u_max:.2f} m/s")
    return cfg, grid, carry, counts, timings["grid_path"]


def ocean_setup(nx, ny, nz, dt, integrator="split_explicit"):
    """The baroclinic channel on channel_hex_mesh(nx, ny, 10 km) with nz
    levels (bench.py:132-158 at 32 x 200 and 20 levels)."""
    from mpas_tpu_torch.cores.ocean.core import OcnConfig
    from mpas_tpu_torch.cores.ocean.init_channel import (
        init_baroclinic_channel)
    from mpas_tpu_torch.mesh.planar import channel_hex_mesh
    cfg = OcnConfig(config_dt=dt, config_time_integrator=integrator)
    return (cfg, *init_baroclinic_channel(channel_hex_mesh(nx, ny, 10000.0),
                                          nz=nz))


def check_small_ocean(device):
    """Phase 4: the f64 baroclinic channel of tests/test_ocean_core.py
    (192 cells, 10 levels) on the card vs the CPU: 3 split-explicit steps
    at dt = 300 s and 4 RK4 steps at dt = 30 s."""
    from mpas_tpu_torch.cores.ocean.core import run_steps
    for integrator, dt, steps in (("split_explicit", 300.0, 3),
                                  ("RK4", 30.0, 4)):
        cfg, grid, state = ocean_setup(8, 26, 10, dt, integrator)
        fields = {}
        for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
            f64 = torch.float64
            t0 = time.perf_counter()
            out = run_steps(grid.to(dev, f64), cfg, state.to(dev, f64),
                            steps)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            print(f"small f64 ocean {integrator} on {where}: {steps} steps "
                  f"in {time.perf_counter() - t0:.2f} s")
            fields[where] = {k: getattr(out, k).cpu().numpy()
                             for k in ("u", "layerThickness", "tracers",
                                       "ubtr")}
        require(float(np.abs(fields["cpu"]["u"]).max()) > 0.0,
                "the small ocean run did not move")
        compare_scaled(f"ocean {integrator}", fields)


# the inits of cores/ocean/init_configs.py: (mesh, 2 steps of the
# integrator of each one's reference test: tests/test_ocean_init_configs.py,
# test_ocean_ecosys_inits.py, test_ocean_fidelity.py:150-154)
OCEAN_INITS = {
    "overflow": ("channel", dict(config_dt=20.0,
                                 config_vert_mix_scheme="cvmix")),
    "internal_waves": ("channel", dict(config_dt=30.0)),
    "cosine_bell": ("sphere", dict(config_dt=600.0,
                                   config_time_integrator="RK4",
                                   config_mom_del2=0.0,
                                   config_tracer_del2=0.0,
                                   config_bottom_drag_coeff=0.0)),
    "lock_exchange": ("channel", dict(config_dt=5.0)),
    "sea_mount": ("channel", dict(config_dt=20.0)),
    "ziso": ("channel", dict(config_dt=60.0)),
    "soma": ("sphere", dict(config_dt=120.0)),
    "isomip": ("channel", dict(config_dt=60.0)),
    "sub_ice_shelf_2d": ("channel", dict(config_dt=30.0)),
    "cvmix_wswsbf": ("channel", dict(config_dt=300.0,
                                     config_vert_mix_scheme="cvmix")),
    "global_ocean_idealized": ("sphere", dict(config_dt=120.0)),
    "iso": ("sphere", dict(config_dt=120.0)),
    "isomip_plus": ("box", dict(config_dt=30.0, config_time_integrator="RK4",
                                config_eos_type="jm")),
    "periodic_planar": ("plane", dict(config_dt=60.0,
                                      config_time_integrator="RK4")),
    "ecosys_column": ("box", dict(config_dt=60.0,
                                  config_time_integrator="RK4")),
    "global_ocean": ("sphere", dict(config_dt=300.0,
                                    config_time_integrator="RK4",
                                    config_mom_del2=1.0e4,
                                    config_tracer_del2=1.0e3)),
}
OCN_STATE = ("u", "layerThickness", "tracers", "ubtr")
# the inits' card-vs-CPU bound where PHYS_RTOL does not hold: cvmix_wswsbf's
# 2 cvmix steps depart 8.4e-11 x max in u and 3.2e-11 x max in ubtr on an
# H100 (700 W), where every other init stays below 9e-12 x max
OCEAN_INIT_RTOL = {"cvmix_wswsbf": 5e-10}


def ocean_on_both(device, fn):
    """fn(device) on the CPU and on the card in float64: {"cpu": {name:
    numpy}, "cuda": ...} of the dicts of tensors it returns."""
    return {w: {k: v.cpu().numpy() for k, v in fn(dev).items()}
            for w, dev in (("cpu", torch.device("cpu")), ("cuda", device))}


def check_small_ocean_inits(device, mesh8):
    """Phase 4: each init of cores/ocean/init_configs.py (6 levels; the
    channel on channel_hex_mesh(8, 26, 5 km), the plane on
    planar_hex_mesh(12, 16, 10 km), the box on box_hex_mesh(8, 24, 2 km)
    (132 cells),
    the sphere the 642-cell one) and init_global_ocean from
    synthetic_woa_dataset() on the 642-cell sphere (10 levels), then 2
    steps of its reference test's integrator with its forcing, f64 on the
    card vs the CPU at PHYS_RTOL x max, or OCEAN_INIT_RTOL's bound (the
    inits are host numpy, the same bits on both; cvmix_wswsbf's 2 steps
    differ by 4e-11 x max between the two packages on the CPU already)."""
    from mpas_tpu_torch.cores.ocean import init_configs
    from mpas_tpu_torch.cores.ocean.core import OcnConfig, run_steps
    from mpas_tpu_torch.cores.ocean.init_global_ocean import (
        init_global_ocean, synthetic_woa_dataset)
    from mpas_tpu_torch.mesh.planar import (box_hex_mesh, channel_hex_mesh,
                                            planar_hex_mesh)
    meshes = {"channel": channel_hex_mesh(8, 26, 5000.0),
              "plane": planar_hex_mesh(12, 16, 10000.0),
              "box": box_hex_mesh(8, 24, 2000.0), "sphere": mesh8}
    f64 = torch.float64
    for name, (kind, cfg_kw) in OCEAN_INITS.items():
        mesh = meshes[kind]
        if name == "cosine_bell":            # the init keeps the radius
            mesh = mesh.scaled(6371000.0)
        if name == "global_ocean":
            out = init_global_ocean(mesh, synthetic_woa_dataset(), nz=10)
        else:
            out = getattr(init_configs, f"init_{name}")(mesh, nz=6)
        forcing = out[2] if len(out) == 3 and not isinstance(out[2], dict) \
            else None
        cfg = OcnConfig(**cfg_kw)

        def run(dev):
            st = run_steps(out[0].to(dev, f64), cfg, out[1].to(dev, f64), 2,
                           None if forcing is None else forcing.to(dev, f64))
            return {k: getattr(st, k) for k in OCN_STATE}
        print(f"ocean init {name} ({out[0].mesh.nCells} cells x "
              f"{out[0].nz}, {cfg.config_time_integrator} dt "
              f"{cfg.config_dt:g} s{', forced' if forcing else ''}):")
        compare_scaled(f"ocean init {name}", ocean_on_both(device, run),
                       OCEAN_INIT_RTOL.get(name, PHYS_RTOL))


def check_land_ice_fluxes(device):
    """Phase 4: init_isomip_plus on box_hex_mesh(6, 12, 2 km), 8 levels,
    warmed by 2.5 C, then 3 x (one split step of 60 s,
    apply_land_ice_fluxes), f64 card vs CPU at PHYS_RTOL x max; the
    cavity melts."""
    from mpas_tpu_torch.cores.ocean.core import OcnConfig, run_steps
    from mpas_tpu_torch.cores.ocean.init_configs import init_isomip_plus
    from mpas_tpu_torch.cores.ocean.land_ice_flux import (
        apply_land_ice_fluxes)
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    grid, state, extras = init_isomip_plus(box_hex_mesh(6, 12, 2000.0),
                                           nz=8)
    cfg = OcnConfig(config_dt=60.0)
    f64 = torch.float64

    def run(dev):
        g, st = grid.to(dev, f64), state.to(dev, f64)
        st = dataclasses.replace(st, tracers=st.tracers + torch.tensor(
            [2.5, 0.0], dtype=f64, device=dev))
        lip, draft = (extras[k].to(dev, f64)
                      for k in ("landIcePressure", "landIceDraft"))
        melt = []
        for _ in range(3):
            st, fx = apply_land_ice_fluxes(g, cfg, run_steps(g, cfg, st, 1),
                                           lip, draft, 60.0)
            melt.append(fx.melt_rate)
        return dict({k: getattr(st, k) for k in OCN_STATE},
                    melt_rate=torch.stack(melt))
    fields = ocean_on_both(device, run)
    print(f"isomip_plus + land-ice fluxes: total melt rate "
          f"{fields['cuda']['melt_rate'].sum():.6e} m/s")
    compare_scaled("land-ice fluxes", fields, PHYS_RTOL)
    require(fields["cuda"]["melt_rate"].sum() > 0.0, "the cavity froze")


def check_bgc_columns(device):
    """Phase 4: bgc_step with DMS, ecosys_step and carbon_step on 24
    seeded f64 columns of 16 levels, card vs CPU at PHYS_RTOL x max; the
    pools stay >= 0."""
    from mpas_tpu_torch.cores.ocean import bgc
    from mpas_tpu_torch.cores.ocean.state import OcnState
    rng = np.random.default_rng(19)
    n, nz = 24, 16
    h = rng.uniform(2.0, 40.0, (n, nz))
    ts = np.stack([rng.uniform(-1.5, 30.0, (n, nz)),
                   rng.uniform(32.0, 37.5, (n, nz))], -1)
    npzd = rng.uniform(0.0, 3.0, (n, nz, 5))
    eco = rng.uniform(0.0, 1.0, (n, nz, 8)) * np.array(
        [30.0, 60.0, 6e-4, 1.0, 1.0, 0.5, 0.1, 0.1])
    carbon = np.stack([rng.uniform(1.85e-3, 2.25e-3, (n, nz)),
                       rng.uniform(2.2e-3, 2.45e-3, (n, nz))], -1)
    sw, wind = rng.uniform(0.0, 400.0, n), rng.uniform(0.0, 15.0, n)

    def run(dev):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        def state(tr):
            return OcnState(u=t(np.zeros((1, nz))), layerThickness=t(h),
                            tracers=t(tr), ubtr=t(np.zeros(1)))
        out = {"npzd_dms": bgc.bgc_step(state(np.concatenate([ts, npzd], -1)),
                                        None, 1800.0, t(sw),
                                        with_dms=True).tracers}
        st = state(np.concatenate([ts, eco, carbon], -1))
        for _ in range(3):
            st = bgc.ecosys_step(st, None, 1800.0, t(sw))
            st, diag = bgc.carbon_step(st, None, 1800.0, st.tracers[:, 0, 0],
                                       st.tracers[:, 0, 1], t(wind), 10, 11)
        return dict(out, ecosys_carbon=st.tracers, **diag)
    fields = ocean_on_both(device, run)
    compare_scaled("bgc columns", fields, PHYS_RTOL)
    require(fields["cuda"]["npzd_dms"][..., 2:].min() >= 0.0
            and fields["cuda"]["ecosys_carbon"][..., 2:].min() >= 0.0,
            "a negative BGC pool")


def check_forcing_group(device, tmp):
    """Phase 4: a ForcingGroup over a 3-record classic NetCDF file written
    here (windStressZonal on 5 cells at 00, 06 and 18 h): constant, linear
    and cyclic (1-day cycle) interpolation at 9 times on the card, equal
    to the same group on the CPU."""
    from mpas_tpu_torch.framework.forcing import ForcingGroup, ForcingStream
    from mpas_tpu_torch.framework.timekeeping import Time, TimeInterval
    from mpas_tpu_torch.io.netcdf import write_netcdf
    times = ["0001-03-01_00:00:00", "0001-03-01_06:00:00",
             "0001-03-01_18:00:00"]
    xt = np.zeros((3, 64), dtype="S1")
    for i, t in enumerate(times):
        xt[i, :len(t)] = [c.encode() for c in t]
    path = os.path.join(tmp, "forcing.nc")
    wind = np.random.default_rng(3).standard_normal((3, 5))
    write_netcdf(path, {"Time": 3, "StrLen": 64, "nCells": 5},
                 {"xtime": (("Time", "StrLen"), xt),
                  "windStressZonal": (("Time", "nCells"), wind)})
    t0 = Time.from_string(times[0])
    kinds = {"constant": dict(), "linear": dict(),
             "cyclic": dict(cycle_start=t0,
                            cycle_duration=TimeInterval.from_seconds(86400))}
    for kind, kw in kinds.items():
        got = {}
        for where, dev in (("cpu", "cpu"), ("cuda", device)):
            g = ForcingGroup("ocean", device=dev, **kw)
            g.add_field(ForcingStream(path, ["windStressZonal"]),
                        "windStressZonal",
                        interpolation="constant" if kind == "constant"
                        else "linear")
            got[where] = [g.get_forcing(t0 + TimeInterval.from_seconds(
                h * 3600.0))["windStressZonal"] for h in
                (-3, 0, 2.5, 6, 11, 18, 21, 30, 47)]
        require(all(x.device.type == "cuda" for x in got["cuda"]),
                "forcing not on the card")
        require(all(torch.equal(a, b.cpu()) for a, b in
                    zip(got["cpu"], got["cuda"])),
                f"forcing {kind}: the card departs from the CPU")
        print(f"forcing {kind}: 9 times on the card equal the CPU's")


REGISTRY_XML = """<?xml version="1.0"?>
<registry model="mpas" core="ocean" core_abbrev="ocn" version="8.0">
  <dims>
    <dim name="nCells" definition="file"/>
    <dim name="nVertLevels" definition="namelist:config_nz"/>
  </dims>
  <nml_record name="time_management">
    <nml_option name="config_dt" type="real" default_value="1800.0"/>
    <nml_option name="config_nz" type="integer" default_value="60"/>
  </nml_record>
  <packages><package name="ecosysPKG"/><package name="gmPKG"/></packages>
  <var_struct name="state" time_levs="2">
    <var name="layerThickness" type="real" dimensions="nVertLevels nCells"/>
    <var name="maxLevelCell" type="integer" dimensions="nCells"/>
    <var name="landMask" type="logical" dimensions="nCells"/>
    <var name="NO3" type="real" dimensions="nVertLevels nCells"
         packages="ecosysPKG"/>
    <var name="bolus" type="real" dimensions="nVertLevels nCells"
         packages="gmPKG"/>
  </var_struct>
</registry>
"""


def check_registry(device, tmp):
    """Phase 4: build_state_pytree on the card from a Registry.xml written
    here, through the repository's registry compiler: shapes, dtypes and
    package gating (gmPKG inactive)."""
    from mpas_tpu_torch.framework.registry import (build_state_pytree,
                                                   generate_config_class,
                                                   load_schema)
    path = os.path.join(tmp, "Registry.xml")
    Path(path).write_text(REGISTRY_XML)
    cfg = generate_config_class(path)()
    tree = build_state_pytree(load_schema(path),
                              {"nCells": 40962, "nVertLevels": cfg.config_nz},
                              active_packages=["ecosysPKG"], device=device)
    st = tree["state"]
    want = {"layerThickness": ((60, 40962), torch.float64),
            "maxLevelCell": ((40962,), torch.int32),
            "landMask": ((40962,), torch.bool),
            "NO3": ((60, 40962), torch.float64)}
    require({k: (tuple(v.shape), v.dtype) for k, v in st.items()} == want,
            f"registry state {st.keys()}")
    require(all(v.device.type == "cuda" and not bool(v.any())
                for v in st.values()), "registry state not zeros on the card")
    print(f"registry: config_dt {cfg.config_dt}, state "
          f"{ {k: tuple(v.shape) for k, v in st.items()} } on the card, "
          "bolus gated out")


def ocean_volume_heat(grid, state):
    """(volume, heat) = (sum h area, sum h T area), summed in float64."""
    area = grid.mesh.areaCell.double()[:, None]
    h = state.layerThickness.double()
    return (float((h * area).sum()),
            float((h * state.tracers[..., 0].double() * area).sum()))


def run_ocean_path(device, card):
    """Phase 5, ocean_channel_10km (bench.py:132-158): the baroclinic
    channel on channel_hex_mesh(32, 200, 10 km), 20 levels, split-explicit
    at dt = 300 s, in float32, through run_steps: host setup, copy to the
    card, one warm step, MAIN_STEPS timed steps, one run_steps call per
    step; the launch counters are zeroed just before the warm step and
    read after every step."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.ocean.core import (
        run_steps, tinydot_launches_per_split_step)
    name = "ocean_channel_10km"
    t0 = time.perf_counter()
    host = ocean_setup(32, 200, OCEAN_NZ, 300.0)
    cfg, grid, state = host
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f32 = torch.float32
    grid, state = grid.to(device, f32), state.to(device, f32)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    mesh = grid.mesh
    nc = mesh.nCells
    print(f"{name} setup: {nc} cells x {grid.nz} levels, {mesh.nEdges} "
          f"edges, maxEdges {mesh.maxEdges}; host build {host_s:.2f} s, "
          f"copy to card {copy_s:.2f} s")
    require((nc, grid.nz, mesh.maxEdges) == (OCEAN_CELLS, OCEAN_NZ, 6),
            f"{name} built the wrong size")

    k2 = tinydot_launches_per_split_step(cfg)
    vol0, heat0 = ocean_volume_heat(grid, state)
    kernels.reset_launch_counts()
    per_step = []
    state = run_steps(grid, cfg, state, 1)                     # warm step
    per_step.append(dict(kernels.launch_counts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        state = run_steps(grid, cfg, state, 1)
        per_step.append(dict(kernels.launch_counts))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = per_step[-1]
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    steps = MAIN_STEPS + 1
    require(counts["acoustic_cell_update"] == 0, counts)
    k2_seen = [b["tinydot"] - a["tinydot"]
               for a, b in zip([{"tinydot": 0}] + per_step, per_step)]
    require(k2_seen == [k2] * steps,
            f"K2 launches per step {k2_seen}, the config implies {k2}")
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        require(bool(torch.isfinite(getattr(state, k)).all()), k)
    vol1, heat1 = ocean_volume_heat(grid, state)
    vol_drift = abs(vol1 - vol0) / vol0
    heat_drift = abs(heat1 - heat0) / abs(heat0)
    s_err = float((state.tracers[..., 1].double() - 35.0).abs().max())
    # four f32 roundings of 35 per step
    s_tol = 4 * steps * torch.finfo(f32).eps * 35.0
    u_wall = float(state.u[mesh.boundaryEdge > 0].abs().max())
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {ms:.2f} ms/step, {nc * MAIN_STEPS / elapsed:.1f} cell-column "
          f"updates/s (columns of {grid.nz} levels: not comparable with "
          f"the atmosphere's 26 or 40); peak device memory {peak_gb:.2f} "
          f"GB; volume drift {vol_drift:.3e}, heat drift {heat_drift:.3e}, "
          f"max |S - 35| {s_err:.3e} (bound {s_tol:.3e}), max |u| on the "
          f"walls {u_wall:g}, max |u| {float(state.u.abs().max()):.4f} m/s; "
          f"launches {counts} (per step: K1 0, K2 {k2})")
    require(vol_drift <= 1e-5, f"volume not conserved: {vol_drift:.3e}")
    require(heat_drift <= 1e-5, f"heat not conserved: {heat_drift:.3e}")
    require(s_err <= s_tol, f"salinity left 35: {s_err:.3e}")
    require(u_wall == 0.0, f"flow through the walls: {u_wall:g}")
    return cfg, grid, state, counts, host


OCEAN_GLOBAL = "ocean_global_120km"
OCEAN_GLOBAL_NZ = 60               # E3SM's global MPAS-Ocean meshes
OCEAN_GLOBAL_PARTS = ("dynamics", "bgc", "analysis", "particles")


def member_census(driver, grid, cfg, state, forcing):
    """(host ms of driver.compute_all, {member: device ms}) of one call
    under torch.profiler, each member's compute in a record_function
    span (the driver's signature dispatch kept through functools.wraps)."""
    import functools

    from torch.profiler import record_function
    insts = driver._instances
    saved = {n: inst.compute for n, inst in insts.items()}

    def spanned(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call
    host = []

    def run():
        t0 = time.perf_counter()
        driver.compute_all(grid, cfg, state, forcing=forcing)
        host.append(1e3 * (time.perf_counter() - t0))
    try:
        for n, fn in saved.items():
            insts[n].compute = spanned(n, fn)
        census = kernel_census(run, spans=tuple(saved))
    finally:
        for n in saved:
            del insts[n].compute
            driver.history[n].pop()
    return host[0], census


def run_ocean_global_path(device, card, mesh64, profile=None):
    """Phase 5, ocean_global_120km (mpas_tpu_torch.tools.ocean_global):
    init_global_ocean on phase 5's 40,962-cell mesh from the WOA-shaped
    180 x 360 x 102 dataset at 60 layers, 12 tracers (T, S, 8 ecosys
    pools, DIC, ALK), float32 on the card; a step is split_step (dt
    900 s, btr 60 s) with the init's wind, ecosys_step and carbon_step;
    every analysis member at a 2-step interval and four ParticleTrackers
    (one per vertical treatment, one particle per ocean cell) every step.
    Host setup (its seconds), copy to the card, one warm step, MAIN_STEPS
    timed steps; the launch counters are zeroed just before the warm
    step. Gates: every field finite, volume conserved, BGC pools >= 0,
    max |u| < 5 m/s, K2 tinydot_launches_per_split_step(cfg) times in
    each step's dynamics and no K1, every particle in an ocean cell.
    Then one profiled step (kernels, busy, each part's device ms), each
    member's device ms and the driver's host ms, and the members and one
    particle step in float64 from the final state on the card and the
    CPU at PHYS_RTOL x max with the same NaN positions."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.cores.ocean.core import (
        tinydot_launches_per_split_step)
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs
    from mpas_tpu_torch.tools import ocean_global as og
    name, f32 = OCEAN_GLOBAL, torch.float32
    t0 = time.perf_counter()
    cfg, host_grid, host_state, host_forcing = og.setup(mesh64,
                                                        OCEAN_GLOBAL_NZ)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coeffs = build_reconstruct_coeffs(host_grid.mesh)
    coeffs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid, state, forcing = (host_grid.to(device, f32),
                            host_state.to(device, f32),
                            host_forcing.to(device, f32))
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    mesh, dt = grid.mesh, cfg.config_dt
    nc, nz, nt = mesh.nCells, grid.nz, state.tracers.shape[-1]
    t0 = time.perf_counter()
    sw = og.shortwave(grid)
    driver = og.analysis_driver(grid, cfg, 2 * dt)
    trackers = og.trackers(grid, cfg, state, coeffs)
    torch.cuda.synchronize()
    members_s = time.perf_counter() - t0
    ocean = torch.zeros(nc, dtype=torch.bool, device=device)
    ocean[og.ocean_cells(grid)] = True
    n_ocean = int(ocean.sum())
    print(f"{name} setup: {nc} cells x {nz} layers, {nt} tracers, "
          f"{n_ocean} ocean cells, dt {dt:g} s, btr {cfg.config_btr_dt:g} "
          f"s; host init {init_s:.2f} s, reconstruction weights "
          f"{coeffs_s:.2f} s, copy to card {copy_s:.2f} s, analysis "
          f"members and 4 x {n_ocean} particles {members_s:.2f} s")
    require((nc, nz, nt, len(driver.members))
            == (mesh64.nCells, OCEAN_GLOBAL_NZ, 12, 19),
            f"{name} built the wrong size")

    k2 = tinydot_launches_per_split_step(cfg)
    vol0 = og.volume(grid, state)
    box = {"state": state, "t": 0.0}

    def step(counts=None):
        """One step of the path; counts (a list) gets the K2 launches of
        its dynamics."""
        before = kernels.launch_counts["tinydot"]
        s = og.dynamics(grid, cfg, box["state"], forcing)
        if counts is not None:
            counts.append(kernels.launch_counts["tinydot"] - before)
        s = og.bgc(grid, s, dt, sw)
        box["t"] += dt
        og.analysis(driver, grid, cfg, s, box["t"], forcing)
        og.particles(trackers, grid, cfg, s, dt)
        box["state"] = s

    kernels.reset_launch_counts()
    og.analysis(driver, grid, cfg, state, 0.0, forcing)
    k2_seen = []
    step(k2_seen)                                           # warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        step(k2_seen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    state = box["state"]

    require(counts["acoustic_cell_update"] == 0, counts)
    require(k2_seen == [k2] * (MAIN_STEPS + 1),
            f"{name}: K2 launches per step's dynamics {k2_seen}, the config "
            f"implies {k2}")
    for k in OCN_STATE:
        require(bool(torch.isfinite(getattr(state, k)).all()), k)
    vol_drift = abs(og.volume(grid, state) - vol0) / vol0
    bgc_min = float(state.tracers[..., 2:].min())
    u_max = float(state.u.abs().max())
    land = ~ocean
    land_e = land[mesh.cellsOnEdge[:, 0]] & land[mesh.cellsOnEdge[:, 1]]
    u_land = float(state.u[land_e].abs().max())
    in_ocean = [bool(ocean[t.state.cell].all()) for t in trackers]
    ms = 1e3 * elapsed / MAIN_STEPS
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {ms:.2f} ms/step, {nc * MAIN_STEPS / elapsed:.1f} cell-column "
          f"updates/s (columns of {nz} layers); peak device memory "
          f"{peak_gb:.2f} GB; volume drift {vol_drift:.3e}, min BGC pool "
          f"{bgc_min:.3e}, max |u| {u_max:.4f} m/s, max |u| on the "
          f"{int(land_e.sum())} land edges {u_land:.4f} m/s (not held: "
          f"the reference's land columns keep 2 active levels, ROADMAP §3); "
          f"particles in ocean cells {in_ocean}; launches {counts} (per "
          f"step's dynamics: K1 0, K2 {k2}; okuboWeiss adds one K2 on "
          f"analysis steps)")
    require(vol_drift <= 1e-5, f"{name}: volume not conserved {vol_drift}")
    require(bgc_min >= 0.0, f"{name}: a negative BGC pool {bgc_min}")
    require(u_max < og.MAX_U, f"{name}: max |u| {u_max}")
    require(all(in_ocean), f"{name}: a particle left the ocean")

    parts = kernel_census(step, og, OCEAN_GLOBAL_PARTS)
    n_kern, busy, part_ms = parts[1:]
    idle = 100.0 * (1.0 - busy / ms)
    print(f"{name} one profiled step (analysis due) on {card}: {n_kern} "
          f"kernels, device busy {busy:.3f} ms ({idle:.1f}% idle against "
          f"the timed {ms:.2f} ms/step); "
          + "; ".join(f"{k} {part_ms[k]:.3f} ms "
                      f"({100.0 * part_ms[k] / busy:.1f}%)"
                      for k in OCEAN_GLOBAL_PARTS))
    host_ms, census = member_census(driver, grid, cfg, box["state"], forcing)
    print(f"{name} analysis, all 19 members once: driver host "
          f"{host_ms:.2f} ms, {census[1]} kernels, device {census[2]:.3f} "
          f"ms; " + ", ".join(f"{k} {v:.3f}" for k, v in
                              sorted(census[3].items(),
                                     key=lambda kv: -kv[1])))
    if profile:
        profile_steps(name, step, profile, og, OCEAN_GLOBAL_PARTS)
    check_ocean_global_f64(device, grid, cfg, box["state"], forcing)
    return counts


def check_ocean_global_f64(device, grid, cfg, state, forcing):
    """ocean_global_120km's final f32 state cast to f64: every member
    (compute_all) and one step of the four ParticleTrackers, on the card
    and on the CPU, at PHYS_RTOL x max with the same NaN positions."""
    from mpas_tpu_torch.tools import ocean_global as og
    f64 = torch.float64
    out = {}
    for where, dev in (("cpu", torch.device("cpu")), ("cuda", device)):
        t0 = time.perf_counter()
        g, s, f = grid.to(dev, f64), state.to(dev, f64), forcing.to(dev, f64)
        driver = og.analysis_driver(g, cfg, 3600.0)
        driver.compute_all(g, cfg, s, forcing=f)
        trs = og.trackers(g, cfg, s)
        og.particles(trs, g, cfg, s, cfg.config_dt)
        res = {f"{n}.{k}": v for n, h in driver.history.items()
               for k, v in h[0][1].items() if isinstance(v, torch.Tensor)}
        for mode, t in zip(og.VERTICAL_MODES, trs):
            res.update({f"particles {mode}.{fl.name}": getattr(t.state,
                                                               fl.name)
                        for fl in dataclasses.fields(t.state)})
        out[where] = {k: v.cpu().numpy() for k, v in res.items()}
        print(f"{OCEAN_GLOBAL} f64 members + particle step on {where}: "
              f"{time.perf_counter() - t0:.2f} s")
    worst = (0.0, "")
    for k, ref in out["cpu"].items():
        got = out["cuda"][k]
        nan = np.isnan(ref) if ref.dtype.kind == "f" else np.zeros(
            ref.shape, bool)
        require(np.array_equal(nan, np.isnan(got) if got.dtype.kind == "f"
                               else nan), f"{k}: NaN positions differ")
        fin = ~nan
        if not fin.any():
            continue
        scale = float(np.abs(ref[fin]).max())
        err = float(np.abs(got[fin].astype(np.float64)
                           - ref[fin].astype(np.float64)).max())
        require(err <= PHYS_RTOL * scale,
                f"{OCEAN_GLOBAL} {k}: the card departs from the CPU "
                f"({err:.3e} of max {scale:.3e})")
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, k)
    print(f"{OCEAN_GLOBAL} f64 card vs CPU: {len(out['cpu'])} outputs held "
          f"at {PHYS_RTOL:g} x max; worst {worst[0]:.3e} x max ({worst[1]})")


# --- sharded runs (mpas_tpu_torch.parallel, the three distributed.py) ---

N_SHARDS = 4
SHARD_REL_F64 = 1e-11   # sharded against unsharded, float64
# the reference's f32 allowance, on its measure max |a - b| / (1 + |b|)
# (__graft_entry__.py:128-133): a max-relative bound would hold the small
# w of these runs to ~1e-7 m/s, below what one f32 rounding of the start
# moves it in 11 steps
SHARD_REL_F32 = 2e-4
ATM_FIELDS = (("u", "edge"), ("w", "cell"), ("theta_m", "cell"),
              ("rho_zz", "cell"))
OCN_FIELDS = (("u", "edge"), ("layerThickness", "cell"), ("tracers", "cell"))


def gathered(smesh, group, fields, obj, mesh):
    """{name: global numpy field} from the owned slots of a sharded run."""
    from mpas_tpu_torch.parallel.runner import gather_field
    return {k: gather_field(smesh, group.stack(getattr(obj, k)), kind,
                            mesh.nCells if kind == "cell" else mesh.nEdges)
            for k, kind in fields}


def compare_sharded(label, got, ref, rel, mixed=False):
    """Hold each gathered field to the unsharded one: at rel x max|ref|,
    or (mixed) at max |got - ref| / (1 + |ref|) <= rel, the reference's
    f32 measure."""
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        diff = np.abs(got[k] - r)
        err = float(diff.max())
        err_mixed = float((diff / (1.0 + np.abs(r))).max())
        print(f"  {label} {k}: sharded vs unsharded max abs err {err:.3e} "
              f"= {err / scale:.3e} x max|ref|, max err/(1+|ref|) "
              f"{err_mixed:.3e} (bound {rel:g} "
              f"{'on err/(1+|ref|)' if mixed else 'x max|ref|'})")
        require(np.isfinite(got[k]).all(), f"{label} {k} not finite")
        require((err_mixed if mixed else err / scale) <= rel,
                f"{label} {k}: the sharded run departs from the unsharded "
                "one")


def shard_atm(grid, carry0, n_parts, device, dtype):
    """(satm, group, grid_l, carry_l): the global host grid and carry0
    (any device) sharded by sfc_partition and placed in loopback."""
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import device_mesh, place
    satm = adist.shard_atm_grid(grid, sfc_partition(grid.mesh, n_parts))
    group = device_mesh(n_parts, device)
    carry_st = adist.shard_atm_carry(satm, carry0.to(torch.device("cpu"),
                                                     dtype))
    return satm, group, satm.local(group, dtype), place(carry_st, group,
                                                        dtype)


def check_small_sharded(device, mesh8):
    """Phase 4b: small float64 sharded runs on the card in loopback, held
    to the same runs unsharded on the card at SHARD_REL_F64 x max: JW
    (642 cells, 10 levels, 3 steps of 1,800 s) at P = 2 and 4; the ocean
    channel (192 cells, 10 levels, 3 split steps of 300 s) at P = 4;
    shallow-water TC5 (642 cells, 5 steps) at P = 4."""
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    from mpas_tpu_torch.cores.ocean import distributed as odist
    from mpas_tpu_torch.cores.ocean.core import run_steps as ocn_run_steps
    from mpas_tpu_torch.cores.sw import distributed as sdist
    from mpas_tpu_torch.cores.sw import test_cases
    from mpas_tpu_torch.cores.sw.config import SWConfig
    from mpas_tpu_torch.cores.sw.state import SWState
    from mpas_tpu_torch.cores.sw.time_integration import (
        run_steps as sw_run_steps)
    from mpas_tpu_torch.parallel.layout import build_sharded_mesh
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import (device_mesh, place,
                                                scatter_field)
    f64 = torch.float64
    cfg, grid, state, diag = jw_setup(mesh8, 10, 1800.0, 960000.0)
    g = grid.to(device, f64)
    carry0 = init_carry(g, cfg, state.to(device, f64), diag.to(device, f64),
                        cfg.config_dt)
    ref = run_steps(g, cfg, carry0, cfg.config_dt, 3)
    ref = {k: getattr(ref.state, k).cpu().numpy() for k, _ in ATM_FIELDS}
    for n_parts in (2, 4):
        satm, group, grid_l, carry_l = shard_atm(grid, carry0, n_parts,
                                                 device, f64)
        out = adist.make_run_steps_atm(satm, cfg, group)(grid_l, carry_l, 3)
        compare_sharded(f"JW P={n_parts}", gathered(
            satm.smesh, group, ATM_FIELDS, out.state, grid.mesh), ref,
            SHARD_REL_F64)

    ocfg, ogrid, ostate = ocean_setup(8, 26, 10, 300.0)
    ref = ocn_run_steps(ogrid.to(device, f64), ocfg, ostate.to(device, f64),
                        3)
    ref = {k: getattr(ref, k).cpu().numpy() for k, _ in OCN_FIELDS}
    socn = odist.shard_ocn_grid(ogrid, sfc_partition(ogrid.mesh, N_SHARDS))
    group = device_mesh(N_SHARDS, device)
    out = odist.make_run_steps_ocn(socn, ocfg, group)(
        socn.local(group, f64),
        place(odist.shard_ocn_state(socn, ostate), group, f64), 3)
    compare_sharded(f"ocean split P={N_SHARDS}", gathered(
        socn.smesh, group, OCN_FIELDS, out, ogrid.mesh), ref, SHARD_REL_F64)

    mesh, st, h_s = test_cases.test_case_5(mesh8)
    scfg = SWConfig(config_dt=900.0, config_test_case=5)
    ref = sw_run_steps(mesh.to(device, f64), scfg, st.to(device, f64),
                       h_s.to(device, f64), 5)
    fields = (("u", "edge"), ("h", "cell"), ("tracers", "cell"))
    ref = {k: getattr(ref, k).cpu().numpy() for k, _ in fields}
    sm = build_sharded_mesh(mesh, sfc_partition(mesh, N_SHARDS),
                            halo_depth=sdist.SW_HALO_DEPTH)
    st_st = SWState(**{k: scatter_field(sm, getattr(st, k), kind)
                       for k, kind in fields})
    out = sdist.make_run_steps(sm, scfg, group)(
        sm.local(group, f64), place(st_st, group, f64),
        group.local(scatter_field(sm, h_s, "cell"), f64), 5)
    compare_sharded(f"sw_tc5 P={N_SHARDS}",
                    gathered(sm, group, fields, out, mesh), ref,
                    SHARD_REL_F64)


def check_nccl_exchange(device, mesh8):
    """Phase 4c: the process-group transport on NCCL, 2 ranks on 2 cards,
    the small JW of phase 4b held to loopback at SHARD_REL_F64; only
    where the machine has two cards (NCCL refuses two ranks on one)."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"process-group exchange on NCCL: not run "
              f"(device_count={n_cards})")
        return
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import device_mesh, spawn_ranks
    f64 = torch.float64
    cfg, grid, state, diag = jw_setup(mesh8, 10, 1800.0, 960000.0)
    carry0 = init_carry(grid, cfg, state, diag, cfg.config_dt)
    satm = adist.shard_atm_grid(grid, sfc_partition(grid.mesh, 2))
    carry_st = adist.shard_atm_carry(satm, carry0)
    loop = adist.run_on_rank(device_mesh(2, device), satm, cfg, carry_st, 3,
                             f64)
    store = Path(__file__).resolve().parent / "build" / "chip_smoke" / \
        "nccl_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    ranks = spawn_ranks(adist.run_on_rank, 2, store,
                        args=(satm, cfg, carry_st, 3, f64),
                        devices=["cuda:0", "cuda:1"])
    for k, _ in ATM_FIELDS:
        err = max(float(np.abs(r[k] - loop[k]).max()) for r in ranks) \
            / float(np.abs(loop[k]).max())
        print(f"  NCCL 2 ranks vs loopback {k}: {err:.3e} x max")
        require(err <= SHARD_REL_F64, f"NCCL run departs from loopback: {k}")
    for r in ranks:
        require(abs(r["dry_mass"] - loop["dry_mass"])
                <= SHARD_REL_F64 * loop["dry_mass"], "NCCL psum_owned")


def in_turns(steppers, steps=5):
    """ms/step of each of two steppers (name -> function advancing its own
    run one step) timed in turns A, B, B, A of `steps` steps, after one
    untimed step each: the host clock around torch.cuda.synchronize()."""
    names = list(steppers)
    for n in names:
        steppers[n]()
    torch.cuda.synchronize()
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        t0 = time.perf_counter()
        for _ in range(steps):
            steppers[n]()
        torch.cuda.synchronize()
        ms[n].append(1e3 * (time.perf_counter() - t0) / steps)
    print("in turns (A, B, B, A), ms/step: " + "; ".join(
        f"{n} {' / '.join(f'{t:.2f}' for t in v)}" for n, v in ms.items()))


def stepper(fn, state):
    """A function that advances `state` by fn(state) at each call."""
    box = [state]

    def step():
        box[0] = fn(box[0])
    return step


def layout_text(sm):
    """The flat sizes and the neighbour schedules' volume per depth."""
    P = sm.n_parts
    vol = "; ".join(
        f"depth {d}: {sm.cell_nx[d].volume:,} cells / "
        f"{sm.edge_nx[d].volume:,} edges / {sm.vertex_nx[d].volume:,} "
        f"vertices in {len(sm.cell_nx[d].perms)}/{len(sm.edge_nx[d].perms)}"
        f"/{len(sm.vertex_nx[d].perms)} rounds" for d in sorted(sm.cell_nx))
    return (f"{P} shards of {sm.mesh.nCells:,} cells / {sm.mesh.nEdges:,} "
            f"edges / {sm.mesh.nVertices:,} vertices (padded): flat "
            f"{P * sm.mesh.nCells:,} cells, {P * sm.mesh.nEdges:,} edges; "
            f"owned cells per shard "
            f"{(sm.owned_cell_mask > 0).sum(1).tolist()}; schedule volume "
            f"{vol}")


def step_sharded(name, device, run, carry_l, per_step, mass_fn):
    """One warm step and MAIN_STEPS timed steps of a sharded runner, the
    launch counts read after every step (zeroed just before the warm
    step); the owned mass before and after. Returns (carry, elapsed s,
    counts, peak GB, drifts)."""
    from mpas_tpu_torch import kernels
    mass0 = mass_fn(carry_l)
    kernels.reset_launch_counts()
    seen = []
    carry_l = run(carry_l)                                   # warm step
    seen.append(dict(kernels.launch_counts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(MAIN_STEPS):
        carry_l = run(carry_l)
        seen.append(dict(kernels.launch_counts))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    zero = {k: 0 for k in kernels.launch_counts}
    for kname, n in per_step.items():
        got = [b[kname] - a[kname] for a, b in zip([zero] + seen, seen)]
        require(got == [n] * (MAIN_STEPS + 1),
                f"{name}: {kname} launches per step {got}, expected {n}")
    mass1 = mass_fn(carry_l)
    drift = [abs(b - a) / abs(a) for a, b in zip(mass0, mass1)]
    return carry_l, elapsed, seen[-1], peak_gb, drift


def run_sharded_jw_path(device, card, host, ref, profile=None):
    """Phase 5b, jw_120km_4way: jw_120km's grid sharded 4 ways by
    sfc_partition at halo depth 4, float32, loopback on the card, from the
    same start as jw_120km (init_carry on the card); 12 K1 and 15 K2
    launches a step; dry mass over owned cells; after the 11 steps the
    gathered fields against jw_120km's (`ref`) at SHARD_REL_F32 on the
    reference's measure."""
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    name, f32 = "jw_120km_4way", torch.float32
    cfg, grid, state, diag = host
    g32 = grid.to(device, f32)
    carry0 = init_carry(g32, cfg, state.to(device, f32),
                        diag.to(device, f32), cfg.config_dt)
    del g32
    t0 = time.perf_counter()
    satm, group, grid_l, carry_l = shard_atm(grid, carry0, N_SHARDS, device,
                                             f32)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    sm = satm.smesh
    print(f"{name} layout, grid and carry sharded and placed in "
          f"{layout_s:.2f} s: {layout_text(sm)}")
    require(sm.mesh.nCells * N_SHARDS == grid_l.mesh.nCells, "flat layout")
    mask = group.local(sm.owned_cell_mask, f32)
    run1 = adist.make_run_steps_atm(satm, cfg, group)
    carry_l, elapsed, counts, peak_gb, drift = step_sharded(
        name, device, lambda c: run1(grid_l, c, 1), carry_l,
        {"acoustic_cell_update": K1_PER_STEP,
         "tinydot": K2_PER_STEP["jw_120km"]},
        lambda c: (adist.dry_mass(grid_l, c, mask, group),))
    for k in STATE_FIELDS:
        require(bool(torch.isfinite(getattr(carry_l.state, k)).all()), k)
    nc = grid.mesh.nCells
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {1e3 * elapsed / MAIN_STEPS:.2f} ms/step, "
          f"{nc * MAIN_STEPS / elapsed:.1f} owned cell-column updates/s "
          f"(over {nc} cells); peak device memory {peak_gb:.2f} GB; dry-mass "
          f"drift over owned cells {drift[0]:.3e}; launches {counts}")
    require(drift[0] <= 1e-5, f"{name}: dry mass not conserved")
    compare_sharded(name, gathered(sm, group, ATM_FIELDS, carry_l.state,
                                   grid.mesh), ref, SHARD_REL_F32, mixed=True)
    check_sharded_restart(name, satm, group, carry_l,
                          lambda c: run1(grid_l, c, 2), grid.mesh)
    step = stepper(lambda c: run1(grid_l, c, 1), carry_l)
    if profile:
        from mpas_tpu_torch.cores.atmosphere import time_integration as ti
        profile_steps(name, step, profile, ti, PROFILE_REGIONS)
    return counts, grid_l.mesh.nCells, step


def check_sharded_restart(name, satm, group, carry_l, run2, mesh):
    """Phase 5b: the sharded carry written by io.sharded.write_sharded
    (group_size 2) and read back by read_sharded: every reassembled field
    equals the gathered one, and 2 steps from the re-sharded restart equal
    2 steps from the carry in memory, bit for bit; the write and read
    seconds and the shards' bytes."""
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.io.sharded import read_sharded, write_sharded
    from mpas_tpu_torch.parallel.runner import gather_field, place
    sm = satm.smesh
    n_global = {"cell": mesh.nCells, "edge": mesh.nEdges,
                "vertex": mesh.nVertices}
    with tempfile.TemporaryDirectory(prefix="restart_shards") as tmp:
        fields, kinds = adist.carry_restart_fields(carry_l, group)
        t0 = time.perf_counter()
        write_sharded(tmp, sm, fields, kinds, n_global, group_size=2)
        write_s = time.perf_counter() - t0
        files = sorted(Path(tmp).glob("restart_shard_*.npz"))
        nbytes = sum(f.stat().st_size for f in files)
        t0 = time.perf_counter()
        back, _ = read_sharded(tmp)
        read_s = time.perf_counter() - t0
    for k, v in fields.items():
        require(np.array_equal(back[k], gather_field(
            sm, v, kinds[k], n_global[kinds[k]])),
            f"{name} restart: {k} reassembled differs from the gathered")
    restarted = place(adist.shard_atm_carry(
        satm, adist.carry_from_restart_fields(back)), group,
        carry_l.state.u.dtype)
    a, _ = adist.carry_restart_fields(run2(carry_l), group)
    b, _ = adist.carry_restart_fields(run2(restarted), group)
    same = [k for k in a if np.array_equal(
        gather_field(sm, a[k], kinds[k], n_global[kinds[k]]),
        gather_field(sm, b[k], kinds[k], n_global[kinds[k]]))]
    print(f"{name} sharded restart: {len(fields)} carry fields in "
          f"{len(files)} shards (group_size 2), {nbytes / 1e6:.1f} MB; "
          f"write {write_s:.2f} s, read {read_s:.2f} s; reassembled = "
          f"gathered bit for bit; 2 steps from the restart = 2 steps in "
          f"memory bit for bit in {len(same)} of {len(a)} fields")
    require(len(same) == len(a),
            f"{name} restart: 2 steps differ in {sorted(set(a) - set(same))}")


def run_sharded_ocean_path(device, card, host, ref, profile=None):
    """Phase 5c, ocean_channel_10km_4way: the channel sharded 4 ways,
    float32, loopback on the card, split-explicit; 245 K2 and no K1 a
    step; volume and heat over owned cells; after the 11 steps the
    gathered fields against ocean_channel_10km's at SHARD_REL_F32 on the
    reference's measure."""
    from mpas_tpu_torch.cores.ocean import distributed as odist
    from mpas_tpu_torch.cores.ocean.core import (
        tinydot_launches_per_split_step)
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import device_mesh, place
    name, f32 = "ocean_channel_10km_4way", torch.float32
    cfg, grid, state = host
    t0 = time.perf_counter()
    socn = odist.shard_ocn_grid(grid, sfc_partition(grid.mesh, N_SHARDS))
    group = device_mesh(N_SHARDS, device)
    grid_l = socn.local(group, f32)
    state_l = place(odist.shard_ocn_state(socn, state.to(
        torch.device("cpu"), f32)), group, f32)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    sm = socn.smesh
    print(f"{name} layout, grid and state sharded and placed in "
          f"{layout_s:.2f} s: {layout_text(sm)}")
    mask = group.local(sm.owned_cell_mask, f32)
    run1 = odist.make_run_steps_ocn(socn, cfg, group)
    state_l, elapsed, counts, peak_gb, drift = step_sharded(
        name, device, lambda s: run1(grid_l, s, 1), state_l,
        {"acoustic_cell_update": 0,
         "tinydot": tinydot_launches_per_split_step(cfg)},
        lambda s: odist.volume_heat(grid_l, s, mask, group))
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        require(bool(torch.isfinite(getattr(state_l, k)).all()), k)
    nc = grid.mesh.nCells
    print(f"{name} float32 on {card}: {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"= {1e3 * elapsed / MAIN_STEPS:.2f} ms/step, "
          f"{nc * MAIN_STEPS / elapsed:.1f} owned cell-column updates/s "
          f"(over {nc} cells); peak device memory {peak_gb:.2f} GB; volume "
          f"drift over owned cells {drift[0]:.3e}, heat {drift[1]:.3e}; "
          f"launches {counts}")
    require(drift[0] <= 1e-5 and drift[1] <= 1e-5,
            f"{name}: volume or heat not conserved")
    compare_sharded(name, gathered(sm, group, OCN_FIELDS, state_l,
                                   grid.mesh), ref, SHARD_REL_F32, mixed=True)
    step = stepper(lambda s: run1(grid_l, s, 1), state_l)
    if profile:
        from mpas_tpu_torch.cores.ocean import core as ocean_core
        profile_steps(name, step, profile, ocean_core,
                      ("split_step", "implicit_vertical_mix"))
    return counts, grid_l.mesh.nCells, step


PROFILE_REGIONS = ("compute_dyn_tend", "acoustic_step", "solve_diagnostics",
                   "recover_large_step_variables", "vert_imp_coefs",
                   "set_smlstep_pert_variables", "advance_scalars",
                   "advance_scalars_mono", "microphysics_step",
                   "divergence_damping_3d", "acoustic_hoist",
                   "reconstruct_cell_winds", "compute_moist_coefficients")


def profile_steps(name, step, out_dir, module=None, regions=(), steps=3,
                  more=()):
    """--profile DIR: torch.profiler over `steps` calls of step(), with a
    record_function span around each function of `module` named in
    `regions`, and of each (module, names) pair in `more` (patched in for
    the run and restored after). Prints device time and kernel count per
    step, K1 and K2, and per region, and writes the per-kernel table to
    DIR/profile_<name>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def spanned(region, fn):
        def call(*args, **kwargs):
            with record_function(region):
                return fn(*args, **kwargs)
        return call

    pairs = ((module, tuple(regions)),) + tuple(more)
    regions = tuple(n for _, names in pairs for n in names)
    saved = [(mod, n, getattr(mod, n)) for mod, names in pairs
             for n in names]
    try:
        for mod, n, fn in saved:
            setattr(mod, n, spanned(n, fn))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)

    # CUDA-side events named after a region are the record_function spans
    # on the device timeline (first to last kernel, gaps included); the
    # rest are kernels
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.key not in regions]
    span = {e.key: e.device_time_total for e in events
            if e.device_type == DeviceType.CUDA and e.key in regions}
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) / steps
    print(f"profile {name} ({steps} steps): device busy {dev_ms:.3f} "
          f"ms/step over {n_kern:.0f} kernels/step")
    for label, prefix in (("K1", "void acoustic_cell_kernel"),
                          ("K2", "void tinydot_kernel")):
        ks = [e for e in kern if e.key.startswith(prefix)]
        n = sum(e.count for e in ks)
        us = sum(e.self_device_time_total for e in ks)
        print(f"  {label} {prefix[5:]}: {n / steps:.0f} launches/step, "
              f"{us / 1e3 / steps:.3f} ms/step, "
              f"{us / n if n else 0.0:.2f} us/launch in the path")
    for e in sorted((e for e in events if e.key in regions
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.device_time_total):
        print(f"  region {e.key}: {e.count / steps:.0f} calls/step, "
              f"kernels {e.device_time_total / 1e3 / steps:.3f} ms/step, "
              f"device-timeline span "
              f"{span.get(e.key, 0.0) / 1e3 / steps:.3f} ms/step")
    table = events.table(sort_by="self_device_time_total", row_limit=60)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{name}.txt").write_text(table)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  kernel {e.key[:70]}: {e.count / steps:.0f}/step, "
              f"{e.self_device_time_total / 1e3 / steps:.3f} ms/step")


def profile_srk3(name, cfg, grid, carry, out_dir):
    """--profile of an atmosphere path, spans around the dycore calls."""
    from mpas_tpu_torch.cores.atmosphere import time_integration as ti
    box = [carry]

    def step():
        box[0] = ti.srk3_step(grid, cfg, box[0], cfg.config_dt)
    profile_steps(name, step, out_dir, ti, PROFILE_REGIONS)


def profile_physics(name, run, out_dir):
    """--profile of a suite path: spans around physics_step, its schemes,
    the microphysics and the dycore calls; then physics_step alone."""
    from mpas_tpu_torch.cores.atmosphere import time_integration as ti
    from mpas_tpu_torch.cores.atmosphere.physics import (
        cam_radiation, cldfra3, convection, driver, gf, gwdo, manager, mynn,
        mynn_sfc, radiation, rrtmg, sfclay, tiedtke, ysu)
    schemes = {
        "supercell_2km_mesoref": (
            (rrtmg, ("rrtmg_lw", "rrtmg_sw")), (cldfra3, ("cal_cldfra3",)),
            (gwdo, ("gwdo",)), (tiedtke, ("tiedtke",)), (ysu, ("ysu",))),
        "supercell_2km_cam": (
            (cam_radiation, ("cam_lw", "cam_sw")),
            (cldfra3, ("cal_cldfra3",)), (gwdo, ("gwdo",)),
            (tiedtke, ("tiedtke",)), (ysu, ("ysu",))),
        "supercell_2km_convperm": (
            (rrtmg, ("rrtmg_lw", "rrtmg_sw")), (cldfra3, ("cal_cldfra3",)),
            (gwdo, ("gwdo",)), (gf, ("gf_convection",)), (mynn, ("mynn",)),
            (mynn_sfc, ("mynn_sfclay",)), (driver, ("thompson",))),
        "supercell_2km_kf": (
            (radiation, ("radiation_lw", "radiation_sw")),
            (sfclay, ("sfclay",)), (ysu, ("ysu",)),
            (convection, ("kf_eta",)))}[name]
    micro = ("microphysics_step_thompson",) \
        if run["cfg"].config_microp_scheme == "mp_thompson" \
        else ("microphysics_step_wsm6",)
    cfg, grid, coeffs, pcfg = (run[k] for k in ("cfg", "grid", "coeffs",
                                                "pcfg"))
    box = [(run["carry"], run["phys"])]

    def step():
        box[0] = run["step"](*box[0])
    profile_steps(name, step, out_dir, ti, PROFILE_REGIONS + micro,
                  more=((manager, ("physics_step",)),) + schemes)

    def physics_only():
        c, p = box[0]
        manager.physics_step(grid, pcfg or manager.PhysicsConfig(),
                             grid.mesh, coeffs, c.state, c.diag, p,
                             cfg.config_dt, gmt_hours=MESOREF_GMT)
    # physics_step alone: its kernels a step (the count a CUDA graph of it
    # would replay)
    profile_steps(f"{name}_physics_step", physics_only, out_dir, manager,
                  ("physics_step",), more=schemes)


# --- phase 6: the command line (python -m mpas_tpu_torch), in-process ---

CLI_REL = 2e-4     # max |a - b| / (1 + |b|), __graft_entry__.py:128-133
CLI_STREAMS = """<streams>
<immutable_stream name="restart" type="input;output"
    filename_template="restart.atmosphere.$Y-$M-$D_$h.$m.$s.nc"
    output_interval="1:00:00"/>
<stream name="output" type="output"
    filename_template="output.atmosphere.$Y-$M-$D_$h.$m.$s.nc"
    output_interval="1:00:00"/>
</streams>
"""


def cli_run(argv):
    """One run of the command line in this process, the launch counts
    zeroed just before and read just after; returns (counts, seconds)."""
    from mpas_tpu_torch import kernels
    from mpas_tpu_torch.__main__ import main
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0, f"python -m mpas_tpu_torch {' '.join(argv)}: exit {rc}")
    return dict(kernels.launch_counts), seconds


def cli_log(run_dir, core):
    """The run's log, and {timer: (calls, seconds)} of its last table."""
    text = (run_dir / f"log.{core}.0000.out").read_text()
    table = text.rsplit("timer table:\n", 1)[1].rstrip("\n")
    rows = {}
    for line in table.splitlines()[1:]:
        name, calls, total, _ = line.rsplit(None, 3)
        rows[name.strip()] = (int(calls), float(total))
    return text, table, rows


def cli_compare(label, got, ref):
    """Every field of output `got` (read from a file) against `ref`, the
    same fields, at CLI_REL; prints the worst and whether bit for bit."""
    worst, same = 0.0, True
    for k, r in ref.items():
        g = got[k][0]              # the file's single record
        require(g.shape == r.shape, f"{label}: {k} {g.shape} {r.shape}")
        a, b = g.astype(np.float64), r.astype(np.float64)
        err = float((np.abs(a - b) / (1.0 + np.abs(b))).max())
        worst = max(worst, err)
        same = same and np.array_equal(g, r)
        require(np.isfinite(a).all() and err <= CLI_REL,
                f"{label}: {k} off by {err:.3e} (bound {CLI_REL})")
    print(f"{label}: {len(ref)} fields, max |a - b| / (1 + |b|) "
          f"{worst:.3e} (bound {CLI_REL}), bit for bit: {same}")
    return worst


def cli_direct(hooks, cfg, spec, device, step):
    """The same run without the command line: hooks.setup, then `step` on
    the run in one call, timed like the driver's "time integration" (no
    warm step, synchronised). Returns (output fields, seconds)."""
    run = hooks.setup(cfg, spec, device, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(run)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({k: a for k, (_, a) in hooks.output_fields(run)[0].items()},
            seconds)


def cli_sizes(run_dir):
    return ", ".join(f"{p.name} {p.stat().st_size / 1e6:.1f} MB"
                     for p in sorted(run_dir.glob("*.nc")))


def run_cli_jw_path(device, card, direct_ms):
    """jw_120km through the command line: 10 steps of 720 s on icos:64
    with output and restart every hour, then a restart from the 01h
    restart for the last hour in the same directory. Both runs hold 12 K1
    and 15 K2 launches a step (and one K2 in each init_carry: setup, and
    resume on restart); the final output equals a direct run_steps of 10
    steps from HOOKS.setup within CLI_REL, the restarted run's final
    output the continuous run's."""
    from mpas_tpu_torch.cores.atmosphere.hooks import HOOKS
    from mpas_tpu_torch.cores.atmosphere.time_integration import run_steps
    from mpas_tpu_torch.io.netcdf import read_netcdf
    name = "jw_120km_cli"
    final = "output.atmosphere.0000-01-01_02.00.00.nc"
    with tempfile.TemporaryDirectory(prefix="jw_120km_cli") as tmp:
        d = Path(tmp)
        (d / "streams.atmosphere").write_text(CLI_STREAMS)
        counts, secs = cli_run(["atmosphere", "--mesh", "icos:64",
                                "--duration", "2:00:00", "-s",
                                str(d / "streams.atmosphere"),
                                "--run-dir", str(d)])
        log, table, rows = cli_log(d, "atmosphere")
        require("completed step 10/10 (0000-01-01_02:00:00)" in log,
                f"{name}: no 10th step in the log")
        files = sorted(p.name for p in d.glob("*.nc"))
        require(files == [f"output.atmosphere.0000-01-01_0{h}.00.00.nc"
                          for h in range(3)]
                + [f"restart.atmosphere.0000-01-01_0{h}.00.00.nc"
                   for h in (1, 2)], f"{name}: files {files}")
        require((d / "restart_timestamp").read_text().strip()
                == "0000-01-01_02:00:00", f"{name}: restart_timestamp")
        sizes = cli_sizes(d)
        continuous = read_netcdf(str(d / final))[0]
        require(continuous["theta_m"].shape == (1, 40962, 26)
                and continuous["theta_m"].dtype == np.float32,
                f"{name}: theta_m {continuous['theta_m'].shape}")
        ms = 1e3 * rows["time integration"][1] / 10
        print(f"{name} on {card}: 10 steps (40,962 cells x 26 levels, f32) "
              f"in {secs:.2f} s with setup and files; time integration "
              f"{ms:.2f} ms/step (the direct jw_120km {direct_ms:.2f} "
              f"ms/step), stream output {rows['stream output'][1]:.3f} s "
              f"in {rows['stream output'][0]} writes; launches {counts}")
        print(f"{name} files: {sizes}")
        print(f"{name} timer table:\n{table}")
        require(counts["acoustic_cell_update"] == K1_PER_STEP * 10
                and counts["tinydot"] == K2_PER_STEP["jw_120km"] * 10 + 1,
                f"{name}: launches {counts}")

        # the restart: start from the 01h restart (restart_timestamp names
        # the last one, 02h), run the last hour
        (d / "namelist.atmosphere").write_text(
            "&nhyd_model\n   config_do_restart = .true.\n"
            "   config_start_time = '0000-01-01_01:00:00'\n"
            "   config_run_duration = '1:00:00'\n/\n")
        counts_r, secs_r = cli_run(["atmosphere", "--mesh", "icos:64", "-n",
                                    str(d / "namelist.atmosphere"), "-s",
                                    str(d / "streams.atmosphere"),
                                    "--run-dir", str(d)])
        log, _, rows_r = cli_log(d, "atmosphere")
        require("Restarted from restart stream at 0000-01-01_01:00:00" in log
                and "completed step 5/5 (0000-01-01_02:00:00)" in log,
                f"{name}: the restarted run's log")
        restarted = read_netcdf(str(d / final))[0]
        print(f"{name} restarted at 01h on {card}: 5 steps in {secs_r:.2f} s "
              f"with setup and files; time integration "
              f"{1e3 * rows_r['time integration'][1] / 5:.2f} ms/step; "
              f"launches {counts_r}")
        require(counts_r["acoustic_cell_update"] == K1_PER_STEP * 5
                and counts_r["tinydot"] == K2_PER_STEP["jw_120km"] * 5 + 2,
                f"{name} restarted: launches {counts_r}")

    cfg = HOOKS.config_cls()

    def step(run):
        run.carry = run_steps(run.grid, cfg, run.carry, cfg.config_dt, 10)
    direct, direct_s = cli_direct(HOOKS, cfg, "icos:64", device, step)
    print(f"{name}: the direct run_steps of 10 steps from HOOKS.setup, "
          f"timed as the driver times them (no warm step), "
          f"{1e3 * direct_s / 10:.2f} ms/step; the command line's "
          f"{ms:.2f}")
    cli_compare(f"{name} final output vs the direct run_steps", continuous,
                direct)
    cli_compare(f"{name} restarted final output vs the continuous run",
                restarted, {k: v[0] for k, v in continuous.items()
                            if k != "xtime"})
    return {"continuous": counts, "restarted": counts_r}, ms


def run_cli_small_path(device, card, hooks, cfg, spec, argv, steps, k2,
                       direct_step):
    """sw or ocean through the command line (`argv` gives it cfg's dt and
    `steps` steps): the final output held to direct_step(run, steps) from
    hooks.setup(cfg) at CLI_REL, K2 launches `k2` a step and no K1."""
    from mpas_tpu_torch.io.netcdf import read_netcdf
    core = hooks.name
    name = f"{core} --mesh {spec}"
    with tempfile.TemporaryDirectory(prefix=f"{core}_cli") as tmp:
        d = Path(tmp)
        counts, secs = cli_run([core, "--mesh", spec, "--run-dir", str(d)]
                               + argv)
        log, table, rows = cli_log(d, core)
        require(f"completed step {steps}/{steps}" in log,
                f"{name}: the log has no step {steps}")
        outputs = sorted(d.glob(f"output.{core}.*.nc"))
        require(len(outputs) == 2, f"{name}: outputs {outputs}")
        got = read_netcdf(str(outputs[-1]))[0]
        print(f"{name} on {card}: {steps} steps in {secs:.2f} s with setup "
              f"and files; time integration "
              f"{1e3 * rows['time integration'][1] / steps:.2f} ms/step; "
              f"files: {cli_sizes(d)}; launches {counts}")
        print(f"{name} timer table:\n{table}")
    require(counts["acoustic_cell_update"] == 0
            and counts["tinydot"] == k2 * steps, f"{name}: {counts}")
    direct, direct_s = cli_direct(hooks, cfg, spec, device,
                                  lambda run: direct_step(run, steps))
    print(f"{name}: the direct run_steps from HOOKS.setup "
          f"{1e3 * direct_s / steps:.2f} ms/step")
    cli_compare(f"{name} final output vs the direct run_steps", got, direct)
    return counts


def run_cli_sw_path(device, card):
    """sw_tc5_120km through the command line: TC5 on icos:64, dt 45 s,
    4 steps (8 K2 a step)."""
    from mpas_tpu_torch.cores.sw.hooks import HOOKS
    from mpas_tpu_torch.cores.sw.time_integration import run_steps
    cfg = HOOKS.config_cls(config_dt=45.0)

    def step(run, n):
        run.state = run_steps(run.mesh, cfg, run.state, run.h_s, n)
    return run_cli_small_path(device, card, HOOKS, cfg, "icos:64",
                              ["--dt", "45", "--duration", "0:03:00"], 4,
                              SW_K2_PER_STEP, step)


def run_cli_ocean_path(device, card):
    """ocean_channel_10km through the command line: the channel on
    channel:32,200,10000, 20 levels, 4 split-explicit steps of the
    default 300 s (245 K2 a step, from the config)."""
    from mpas_tpu_torch.cores.ocean.core import (
        run_steps, tinydot_launches_per_split_step)
    from mpas_tpu_torch.cores.ocean.hooks import HOOKS
    cfg = HOOKS.config_cls()

    def step(run, n):
        run.state = run_steps(run.grid, cfg, run.state, n)
    return run_cli_small_path(device, card, HOOKS, cfg,
                              "channel:32,200,10000",
                              ["--duration", "0:20:00"], 4,
                              tinydot_launches_per_split_step(cfg), step)


def run_cli_file_path(device, card, grid_path):
    """jw_120km from a grid file through the command line: `atmosphere
    --mesh file:<real_120km's netCDF4 grid file>` for 2 steps of 720 s,
    held to the same 2 steps with `--mesh icos:64` (the mesh the file was
    written from) at CLI_REL, bit for bit or not printed; 12 K1 and 15 K2
    launches a step in both (and one K2 in each init_carry)."""
    from mpas_tpu_torch.io.netcdf import read_netcdf
    finals, counts = {}, {}
    for label, spec in (("file", "file:" + grid_path), ("icos", "icos:64")):
        with tempfile.TemporaryDirectory(prefix=f"jw_{label}_cli") as tmp:
            d = Path(tmp)
            counts[label], secs = cli_run(["atmosphere", "--mesh", spec,
                                           "--duration", "0:24:00",
                                           "--run-dir", str(d)])
            log, _, rows = cli_log(d, "atmosphere")
            require("completed step 2/2" in log,
                    f"--mesh {spec}: the log has no step 2")
            outputs = sorted(d.glob("output.atmosphere.*.nc"))
            require(len(outputs) == 2, f"--mesh {spec}: outputs {outputs}")
            finals[label] = read_netcdf(str(outputs[-1]))[0]
            print(f"atmosphere --mesh {spec} on {card}: 2 steps in "
                  f"{secs:.2f} s with setup and files (initialize, the "
                  f"mesh and init_jw, {rows['initialize'][1]:.2f} s); time "
                  f"integration {1e3 * rows['time integration'][1] / 2:.2f} "
                  f"ms/step; launches {counts[label]}")
        require(counts[label]["acoustic_cell_update"] == K1_PER_STEP * 2
                and counts[label]["tinydot"]
                == K2_PER_STEP["jw_120km"] * 2 + 1,
                f"--mesh {spec}: launches {counts[label]}")
    cli_compare("jw_120km from the grid file vs --mesh icos:64, 2 steps",
                finals["file"], {k: v[0] for k, v in finals["icos"].items()
                                 if k != "xtime"})
    return counts


def timed(label, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile 3 steps of jw_120km, "
                             "sw_tc5_120km, real_120km, supercell_2km, "
                             "supercell_2km_mesoref, supercell_2km_convperm, "
                             "supercell_2km_kf, supercell_2km_cam, "
                             "jw_var60_15, "
                             "ocean_channel_10km, the two 4-way paths and "
                             "ocean_global_120km; "
                             "the kernel tables go to "
                             "DIR/profile_<path>.txt")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of real_120km's first guess")
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

    klib = timed("kernel build", load_library)
    print(f"kernels built in {klib.build_seconds:.2f} s "
          f"({klib.path.name}); nvcc/ptxas:\n{klib.log.strip()}")

    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
    kernel_results = timed("kernel parity and device time", check_kernels,
                           device)
    mesh8 = icosahedral_mesh(8, lloyd_iters=2)
    timed("small f64 JW", check_small_trajectory, device, mesh8)
    timed("small f64 sw_tc5", check_small_sw, device, mesh8)
    timed("small f64 varres JW", check_small_varres, device)
    timed("small f64 supercell", check_small_supercell, device)
    timed("small f64 supercell WSM6", check_small_wsm6, device)
    timed("small f64 supercell suite + WSM6", check_small_suite, device)
    timed("small f64 JW sphere suite + WSM6", check_small_sphere_suite,
          device, mesh8)
    timed("small f64 supercell convperm + Thompson", check_small_convperm,
          device)
    timed("small f64 supercell Kain-Fritsch + WSM6", check_small_kf, device)
    timed("small f64 supercell CAM suite + WSM6 + 2d_fixed", check_small_cam,
          device)
    timed("small f64 JW rayleigh_damp_u + v_eddy_visc2",
          check_small_jw_options, device, mesh8)
    timed("f64 rrtmg with o3_climatology", check_rrtmg_o3, device)
    timed("f64 urban and slab ocean", check_urban_oml, device)
    timed("small f64 kf_eta deep columns", check_kf_column, device)
    timed("small f64 ocean", check_small_ocean, device)
    timed("small f64 ocean inits + 2 steps", check_small_ocean_inits, device,
          mesh8)
    timed("f64 land-ice fluxes", check_land_ice_fluxes, device)
    timed("f64 BGC and carbonate columns", check_bgc_columns, device)
    with tempfile.TemporaryDirectory(prefix="framework_io") as tmp:
        timed("forcing group", check_forcing_group, device, tmp)
        timed("registry", check_registry, device, tmp)
    timed("small f64 real-data init + 3 steps", check_small_real, device,
          mesh8)
    timed("f64 regional zones, LBC and IAU", check_regional_iau, device)
    timed("small f64 sharded, loopback", check_small_sharded, device, mesh8)
    timed("process group on NCCL", check_nccl_exchange, device, mesh8)

    # one 40,962-cell mesh for jw_120km and sw_tc5_120km: each init
    # scales its own copy
    mesh64 = timed("icosahedral_mesh(64, 4)", icosahedral_mesh, 64, 4)
    counts = {}
    jw = timed("jw_120km", run_path, "jw_120km", device, card,
               lambda: jw_setup(mesh64, 26, 720.0, 120000.0))
    cfg, grid, carry, counts["jw_120km"] = jw[:4]
    jw_ms = jw[7]
    require((grid.mesh.nCells, grid.vert.nz) == (40962, 26),
            "jw_120km built the wrong size")
    if args.profile:
        profile_srk3("jw_120km", cfg, grid, carry, args.profile)
    jw_final = (grid, carry.state, carry.diag)     # for phase 5d
    jw_ref = {k: getattr(carry.state, k).cpu().numpy() for k, _ in ATM_FIELDS}
    counts["jw_120km_4way"], flat_nc, jw4_step = timed(
        "jw_120km_4way", run_sharded_jw_path, device, card, jw[6], jw_ref,
        args.profile)
    from mpas_tpu_torch.cores.atmosphere.time_integration import srk3_step
    in_turns({"jw_120km": stepper(lambda c: srk3_step(grid, cfg, c,
                                                      cfg.config_dt), carry),
              "jw_120km_4way": jw4_step})
    del jw, jw_ref, grid, carry, jw4_step
    kernel_results.update(timed(
        "kernel parity and device time at jw_120km_4way's flat shapes",
        check_kernels, device, (("jw_120km_4way", flat_nc, 26),),
        (("jw_120km_4way", flat_nc, ((6, 6, 26), (6, 6, 52), (3, 6, 26))),)))
    sw = timed("sw_tc5_120km", run_sw_path, device, card, mesh64)
    counts["sw_tc5_120km"] = sw[-1]
    if args.profile:
        cfg, mesh, state, h_s, _ = sw
        from mpas_tpu_torch.cores.sw import time_integration as sw_ti
        box = [state]

        def sw_step():
            box[0] = sw_ti.rk4_step(mesh, cfg, box[0], h_s, cfg.config_dt)
        profile_steps("sw_tc5_120km", sw_step, args.profile, sw_ti,
                      ("stage_tendencies",))
    # phase 6's mesh cache: the command line's icos:64 is this mesh
    from mpas_tpu_torch.mesh.cache import save_mesh
    cli_cache = tempfile.TemporaryDirectory(prefix="mesh_cache")
    save_mesh(mesh64, os.path.join(cli_cache.name, "icos64_l4.npz"))
    del sw
    # real_120km's grid file stays for phase 6's --mesh file: run
    grid_dir = tempfile.TemporaryDirectory(prefix="real_120km")
    cfg, grid, carry, counts["real_120km"], grid_path = timed(
        "real_120km", run_real_path, device, card, mesh64, grid_dir.name,
        args.seed)
    if args.profile:
        profile_srk3("real_120km", cfg, grid, carry, args.profile)
    del grid, carry
    cfg, grid, carry, counts["supercell_2km"] = timed(
        "supercell_2km", run_supercell_path, device, card)
    if args.profile:
        profile_srk3("supercell_2km", cfg, grid, carry, args.profile)
    del grid, carry
    for name, path in (("supercell_2km_mesoref", run_mesoref_path),
                       ("supercell_2km_convperm", run_convperm_path),
                       ("supercell_2km_kf", run_kf_path),
                       ("supercell_2km_cam", run_cam_path)):
        run = timed(name, path, device, card)
        counts[name] = run["counts"]
        if args.profile:
            profile_physics(name, run, args.profile)
        if name == "supercell_2km_cam":
            cam_final = (run["grid"], run["carry"].state, run["carry"].diag)
        del run
    cfg, grid, carry, counts["jw_var60_15"] = timed(
        "jw_var60_15", run_var_path, device, card)
    if args.profile:
        profile_srk3("jw_var60_15", cfg, grid, carry, args.profile)
    del grid, carry
    cfg, grid, state, counts["ocean_channel_10km"], ocean_host = timed(
        "ocean_channel_10km", run_ocean_path, device, card)
    if args.profile:
        from mpas_tpu_torch.cores.ocean import core as ocean_core
        box = [state]

        def ocean_step():
            box[0] = ocean_core.ocn_timestep(grid, cfg, box[0],
                                             cfg.config_dt)
        profile_steps("ocean_channel_10km", ocean_step, args.profile,
                      ocean_core, ("split_step", "implicit_vertical_mix"))
    ocean_ref = {k: getattr(state, k).cpu().numpy() for k, _ in OCN_FIELDS}
    counts["ocean_channel_10km_4way"], flat_nc, ocean4_step = timed(
        "ocean_channel_10km_4way", run_sharded_ocean_path, device, card,
        ocean_host, ocean_ref, args.profile)
    from mpas_tpu_torch.cores.ocean.core import ocn_timestep
    in_turns({"ocean_channel_10km": stepper(
        lambda s: ocn_timestep(grid, cfg, s, cfg.config_dt), state),
        "ocean_channel_10km_4way": ocean4_step})
    del grid, state, ocean4_step
    kernel_results.update(timed(
        "kernel parity and device time at ocean_channel_10km_4way's flat "
        "shapes", check_kernels, device, (),
        (("ocean_channel_10km_4way", flat_nc, ((6, 6, 1), (6, 6, 20),
                                               (6, 6, 40))),)))
    counts[OCEAN_GLOBAL] = timed(OCEAN_GLOBAL, run_ocean_global_path, device,
                                 card, mesh64, args.profile)
    del mesh64

    # phase 5d: the diagnostics on two paths' final states
    timed("diagnostics on supercell_2km_cam", check_diagnostics,
          "supercell_2km_cam", device, *cam_final, DIAG_NAMES)
    timed("diagnostics on jw_120km", check_diagnostics, "jw_120km", device,
          *jw_final, DIAG_NAMES[:3])
    del cam_final, jw_final

    # phase 6: the command line in this process, its mesh cache seeded
    saved_cache = os.environ.get("MPAS_TPU_TORCH_CACHE")
    os.environ["MPAS_TPU_TORCH_CACHE"] = cli_cache.name
    try:
        cli_counts, cli_ms = timed("jw_120km via the command line",
                                   run_cli_jw_path, device, card, jw_ms)
        counts["jw_120km_cli"] = cli_counts["continuous"]
        counts["jw_120km_cli_restarted"] = cli_counts["restarted"]
        counts["sw_tc5_120km_cli"] = timed(
            "sw_tc5_120km via the command line", run_cli_sw_path, device,
            card)
        counts["ocean_channel_10km_cli"] = timed(
            "ocean_channel_10km via the command line", run_cli_ocean_path,
            device, card)
        file_counts = timed("jw_120km via the command line from the grid "
                            "file", run_cli_file_path, device, card,
                            grid_path)
        counts["jw_120km_file_cli"] = file_counts["file"]
        counts["jw_120km_icos_cli"] = file_counts["icos"]
    finally:
        if saved_cache is None:
            os.environ.pop("MPAS_TPU_TORCH_CACHE")
        else:
            os.environ["MPAS_TPU_TORCH_CACHE"] = saved_cache
        cli_cache.cleanup()
        grid_dir.cleanup()
    print(f"jw_120km on {card}: {cli_ms:.2f} ms/step through the command "
          f"line, {jw_ms:.2f} ms/step direct (phase 5)")

    numbers = kernel_json_numbers(kernel_results)
    sources = {"acoustic_cell_update": ("mpas_tpu_torch/csrc/acoustic.cu",
                                        "mpas_tpu/kernels/acoustic.py:146"),
               "tinydot": ("mpas_tpu_torch/csrc/tinydot.cu",
                           "mpas_tpu/kernels/tinydot.py:44")}
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[name] for c in counts.values()),
         **numbers[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
