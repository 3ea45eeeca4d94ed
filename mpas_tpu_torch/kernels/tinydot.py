"""K2: per-cell tiny contraction (CUDA source: csrc/tinydot.cu).

Replaces the Pallas kernel mpas_tpu/kernels/tinydot.py:tinydot with the same
semantics: out[c, p, :] = sum_i w[c, p, i] * x[c, i, :] for w (nC, P, I)
and x (nC, I, K).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.build import check_launch, load_library


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
    out = torch.empty((nc, P, K), dtype=w.dtype, device=w.device)
    lib = load_library().lib
    fn = lib.mpas_tinydot_f32 if w.dtype == torch.float32 \
        else lib.mpas_tinydot_f64
    stream = torch.cuda.current_stream(w.device).cuda_stream
    check_launch(fn(w.device.index, nc, P, I, K, w.data_ptr(), x.data_ptr(),
                    out.data_ptr(), stream), "tinydot")
    kernels.launch_counts["tinydot"] += 1
    return out
