"""K2: per-cell tiny contraction (CUDA source: csrc/tinydot.cu).

Replaces the Pallas kernel mpas_tpu/kernels/tinydot.py:tinydot with the same
semantics: out[c, p, :] = sum_i w[c, p, i] * x[c, i, :] for w (nC, P, I)
and x (nC, I, K).

The kernel runs one block per tile of consecutive cells; `plan` picks the
tile on the host, and `bytes_moved`/`operations` give the work that bounds
its time on the card.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.build import check_launch, load_library

# Tiles of at most 32 cells and 24 KB, picked by a sweep of 8-64 cells at
# every path's shape on the H100 (PERF.md)
SMEM_BUDGET = 24 * 1024
MAX_COLS = 32
MAX_I = 16                  # csrc/tinydot.cu: MPAS_TINYDOT_MAX_I


def values_per_cell(P: int, I: int, K: int) -> int:
    """Values K2 moves per cell: w and x read once, out written once."""
    return P * I + I * K + P * K


def bytes_moved(nc: int, P: int, I: int, K: int, itemsize: int) -> int:
    return itemsize * nc * values_per_cell(P, I, K)


def operations(nc: int, P: int, I: int, K: int) -> int:
    """Multiplies and adds of one call."""
    return nc * P * K * (2 * I - 1)


def smem_bytes(cols: int, P: int, I: int, K: int, itemsize: int) -> int:
    """Shared memory of a tile of `cols` cells (csrc/tinydot.cu): the w
    tile, padded to 16 bytes, then the x tile."""
    return -(-cols * P * I * itemsize // 16) * 16 + cols * I * K * itemsize


def plan(P: int, I: int, K: int, itemsize: int):
    """(cols, threads, shared-memory bytes) of K2's tiles (kernels.fit_tile),
    a thread per (cell, k) up to 256; raises ValueError where the kernel
    cannot take the shape."""
    if not 1 <= I <= MAX_I or P < 1 or K < 1:
        raise ValueError(f"tinydot: (P, I, K) = ({P}, {I}, {K}); the kernel "
                         f"takes P, K >= 1 and 1 <= I <= {MAX_I}")
    cols, smem = kernels.fit_tile(
        "tinydot", lambda c: smem_bytes(c, P, I, K, itemsize), SMEM_BUDGET,
        MAX_COLS)
    threads = min(kernels.MAX_THREADS, -(-cols * K // 32) * 32)
    return cols, threads, smem


def tinydot_plain(w, x):
    """Plain PyTorch version."""
    return torch.einsum("cpi,cik->cpk", w, x)


def tinydot(w, x):
    """K2 for CUDA tensors; the plain version for CPU tensors."""
    if w.device.type == "cpu":
        return tinydot_plain(w, x)
    if w.device.type != "cuda":
        raise ValueError(f"tinydot: no kernel for device {w.device}")
    if w.dim() != 3 or x.dim() != 3 or x.shape[:2] != (w.shape[0],
                                                        w.shape[2]):
        raise ValueError(f"tinydot: shapes {tuple(w.shape)} x "
                         f"{tuple(x.shape)} are not (nC,P,I) x (nC,I,K)")
    if x.device != w.device or x.dtype != w.dtype:
        raise ValueError(f"tinydot: w is {w.dtype} on {w.device}, x is "
                         f"{x.dtype} on {x.device}")
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tinydot: unsupported dtype {w.dtype}")
    if not (w.is_contiguous() and x.is_contiguous()):
        raise ValueError("tinydot: w and x must be contiguous")
    nc, P, I = w.shape
    K = x.shape[2]
    cols, threads, smem = plan(P, I, K, w.element_size())
    out = torch.empty((nc, P, K), dtype=w.dtype, device=w.device)
    lib = load_library().lib
    fn = lib.mpas_tinydot_f32 if w.dtype == torch.float32 \
        else lib.mpas_tinydot_f64
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(fn(w.device.index, nc, P, I, K, cols, threads, smem,
                    w.data_ptr(), x.data_ptr(), out.data_ptr(), stream),
                 "tinydot")
    kernels.launch_counts["tinydot"] += 1
    return out
