"""K3: the ocean's implicit vertical-mix column solve (CUDA source:
csrc/vmix.cu).

Replaces no Pallas kernel: it does in one launch what the plain version's
Thomas loop (vmix_solve_plain, ops/matrix.py) does in ~8 launches a level,
for cores/ocean/core.py:implicit_vertical_mix. One call solves the
backward-Euler diffusion of `field` down each column: field (n, nz)
(velocity, on edges) or (n, nz, ntr) (tracers, on cells, sharing one
matrix a column); h (n, nz) the layer thickness at the field's points,
kappa (n, nz-1) the diffusivity at the inner interfaces, mask (n, nz) the
live levels or None (all live), bottom_drag the quadratic drag coefficient
(velocity only), boundary (n,) or None: each column's solution comes back
times (1 - boundary).

The kernel runs one block per tile of consecutive columns; `plan` picks the
tile on the host, and `bytes_moved`/`operations` give the work that bounds
its time on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.build import check_launch, load_library
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

# Tiles of at most 24 columns, 96 sweep threads and 32 KB, in blocks of at
# least 128 threads, picked by a sweep on the H100 (PERF.md): 8 columns of
# 12 tracers at 60 levels, 24 edge columns of the velocity solve
SMEM_BUDGET = 32 * 1024
SWEEP_THREADS = 96
MAX_COLS = 24
MIN_THREADS = 128
MAX_NZ = 128               # csrc/vmix.cu: 32 * MPAS_VMIX_MAXE


def bytes_moved(n: int, nz: int, ntr: int, itemsize: int,
                masked: bool = True) -> int:
    """Least bytes one call moves: the field read and written, h, kappa
    and (masked) the level mask read once. The velocity solve's boundary
    row (n values, 0.3% of its bytes at 60 levels) is left out, so that the
    shape alone fixes the count."""
    return itemsize * n * (2 * nz * ntr + (3 if masked else 2) * nz - 1)


def operations(n: int, nz: int, ntr: int) -> int:
    """Floating-point operations of one call, a division counted as one:
    the coefficients and the factor, 16 a level (hi 3, g 3, the clamped h
    1, a and c 4, b 2, den 2, cp 1; the bottom drag's few a column left
    out), and each right-hand side's two sweeps, 5 a level."""
    return n * nz * (16 + 5 * ntr)


def coef_stride(nz: int, itemsize: int) -> int:
    """csrc/vmix.cu: the row stride of h, kappa and the mask, the least >=
    nz that is an odd number of 16-byte words."""
    v = 16 // itemsize
    return (-(-nz // v) | 1) * v


def field_stride(nz: int, ntr: int, itemsize: int) -> int:
    """csrc/vmix.cu: the field's row stride, coef_stride with one
    right-hand side, else the least >= nz * ntr that is ntr modulo the
    values of one 128-byte bank row."""
    if ntr == 1:
        return coef_stride(nz, itemsize)
    w, length = 128 // itemsize, nz * ntr
    return length + (ntr - length) % w


def smem_bytes(cols: int, nz: int, ntr: int, itemsize: int) -> int:
    """Shared memory of a tile of `cols` columns (csrc/vmix.cu:tile_bytes):
    the field rows, then the h, kappa and mask rows, each region 16-byte
    aligned."""
    def region(values):
        return -(-values * itemsize // 16) * 16
    return (region(cols * field_stride(nz, ntr, itemsize))
            + 3 * region(cols * coef_stride(nz, itemsize)))


def plan(nz: int, ntr: int, itemsize: int):
    """(cols, threads, shared-memory bytes) of K3's tiles (kernels.fit_tile):
    at most MAX_COLS columns, SWEEP_THREADS (column, tracer) pairs and
    SMEM_BUDGET bytes, a thread per pair in whole warps (and with more than
    one tracer a warp more, which factors), MIN_THREADS to 256; raises
    ValueError where the kernel cannot take the shape."""
    if not 1 <= nz <= MAX_NZ or ntr < 1:
        raise ValueError(f"vmix_solve: (nz, ntr) = ({nz}, {ntr}); the "
                         f"kernel takes 1 <= nz <= {MAX_NZ}, ntr >= 1")
    cols, smem = kernels.fit_tile(
        "vmix_solve", lambda c: smem_bytes(c, nz, ntr, itemsize),
        SMEM_BUDGET, max(1, min(MAX_COLS, SWEEP_THREADS // ntr)))
    sweep = -(-cols * ntr // 32) * 32
    threads = min(kernels.MAX_THREADS,
                  max(MIN_THREADS, sweep + (32 if ntr > 1 else 0)))
    return cols, threads, smem


def example_args(n: int, nz: int, ntr: int = 0, seed: int = 0):
    """Seeded K3 arguments (numpy float64) for checks of the kernel against
    its plain version, with the ocean's magnitudes: 1-100 m layers, a
    diffusivity up to 1 m2/s (convective), a 0/1 mask with maxLevel drawn
    from 0 (a dead column) to nz and a boundary row. ntr = 0 gives the
    velocity's (n, nz) field, else (n, nz, ntr) tracers."""
    rng = np.random.default_rng(seed)
    shape = (n, nz) if ntr == 0 else (n, nz, ntr)
    max_level = rng.integers(0, nz + 1, n)
    max_level[rng.uniform(size=n) < 0.3] = nz
    return dict(field=rng.standard_normal(shape),
                h=rng.uniform(1.0, 100.0, (n, nz)),
                kappa=10.0 ** rng.uniform(-5.0, 0.0, (n, nz - 1)),
                mask=(np.arange(nz)[None, :]
                      < max_level[:, None]).astype(np.float64),
                boundary=(rng.uniform(size=n) < 0.05).astype(np.float64))


def _solve_plain(field, h_field, kappa, dt, bottom_drag=0.0, mask=None):
    # interface diffusivity flux kappa/dz_int between layers; dead
    # interfaces (below maxLevel) carry no mixing, so the bottom is a
    # no-flux wall wherever the bathymetry sits
    hi = torch.clamp(0.5 * (h_field[..., 1:] + h_field[..., :-1]),
                     min=1e-12)
    if mask is not None:
        kappa = kappa * mask[..., 1:]
    g = dt * kappa / hi
    gu = F.pad(g, (1, 0))                # above-interface coefficient
    gl = F.pad(g, (0, 1))                # below-interface coefficient
    h_safe = torch.clamp(h_field, min=1e-12)
    a = -gu / h_safe
    c = -gl / h_safe
    b = 1.0 - a - c
    if bottom_drag > 0.0:
        # quadratic bottom drag, linearized (ref:
        # ocn_vel_forcing_bottomdrag) at the true bottom layer: the
        # last live level of each column, not index nz-1
        if mask is None:
            spd = field[..., -1].abs()
            b[..., -1] += dt * bottom_drag * spd / h_safe[..., -1]
        else:
            below = F.pad(mask[..., 1:], (0, 1))
            bottom = mask * (1.0 - below)          # one-hot bottom level
            spd_b = (field.abs() * bottom).sum(-1, keepdim=True)
            b = b + bottom * dt * bottom_drag * spd_b / h_safe
    return tridiagonal_solve(a, b, c, field)


def vmix_solve_plain(field, h, kappa, dt, mask=None, bottom_drag=0.0,
                     boundary=None):
    """Plain PyTorch version: the Thomas loop of ops/matrix.py, one solve
    per tracer of a 3-D field, stacked."""
    if field.dim() == 3:
        x = torch.stack(
            [_solve_plain(field[..., i], h, kappa, dt, bottom_drag, mask)
             for i in range(field.shape[-1])], dim=-1)
    else:
        x = _solve_plain(field, h, kappa, dt, bottom_drag, mask)
    if boundary is None:
        return x
    keep = (1.0 - boundary)[:, None]
    return x * (keep if x.dim() == 2 else keep[..., None])


def vmix_solve(field, h, kappa, dt, mask=None, bottom_drag=0.0,
               boundary=None):
    """K3 for CUDA tensors; the plain version for CPU tensors."""
    if field.device.type == "cpu":
        return vmix_solve_plain(field, h, kappa, dt, mask, bottom_drag,
                                boundary)
    if field.device.type != "cuda":
        raise ValueError(f"vmix_solve: no kernel for device {field.device}")
    if field.dim() not in (2, 3):
        raise ValueError(f"vmix_solve: field has shape {tuple(field.shape)},"
                         " expected (n, nz) or (n, nz, ntr)")
    n, nz = field.shape[:2]
    ntr = field.shape[2] if field.dim() == 3 else 1
    if bottom_drag != 0.0 and ntr != 1:
        raise ValueError("vmix_solve: bottom drag takes one right-hand side")
    dtype = field.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vmix_solve: unsupported dtype {dtype}")
    shapes = {"field": tuple(field.shape), "h": (n, nz),
              "kappa": (n, nz - 1), "mask": (n, nz), "boundary": (n,)}
    args = dict(field=field, h=h, kappa=kappa, mask=mask, boundary=boundary)
    for name, t in args.items():
        if t is None:
            continue
        if t.device != field.device or t.dtype != dtype:
            raise ValueError(f"vmix_solve: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on "
                             f"{field.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"vmix_solve: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"vmix_solve: {name} is not contiguous")
    cols, threads, smem = plan(nz, ntr, field.element_size())
    out = torch.empty_like(field)
    lib = load_library().lib
    fn = lib.mpas_vmix_solve_f32 if dtype == torch.float32 \
        else lib.mpas_vmix_solve_f64
    stream = torch.cuda.current_stream(field.device).cuda_stream
    ptrs = [None if t is None else t.data_ptr()
            for t in (field, h, kappa, mask, boundary)]
    check_launch(fn(field.device.index, n, nz, ntr, cols, threads, smem,
                    float(dt), float(bottom_drag), *ptrs, out.data_ptr(),
                    stream), "vmix_solve")
    kernels.launch_counts["vmix_solve"] += 1
    return out
