"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

Shapes are the main path's (40,962 cells, 26 levels). Tolerances: float64
1e-12 x max|plain| (summation order only); float32 1e-5 for K1, whose
Thomas recurrence amplifies differently contracted FMAs, 1e-6 for K2.
"""

import numpy as np
import pytest
import torch

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                             acoustic_cell_update_plain,
                                             example_args)
from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain

K2_SHAPES = [(6, 6, 26), (6, 6, 52), (3, 6, 26)]   # (P, I, K) on the path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def assert_close(got, ref, rel):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.device == r.device
        assert float((g - r).abs().max()) <= rel * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_acoustic_kernel_matches_plain(cuda_device, dtype, rel):
    a = {k: torch.from_numpy(v).to(cuda_device, dtype)
         for k, v in example_args(40962, 26).items()}
    kernels.reset_launch_counts()
    got = acoustic_cell_update(26, 0.1, 120.0, **a)
    assert kernels.launch_counts["acoustic_cell_update"] == 1
    assert_close(got, acoustic_cell_update_plain(26, 0.1, 120.0, **a), rel)


@pytest.mark.cuda
@pytest.mark.parametrize("P,I,K", K2_SHAPES)
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_tinydot_kernel_matches_plain(cuda_device, P, I, K, dtype, rel):
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((40962, P, I))).to(
        cuda_device, dtype)
    x = torch.from_numpy(rng.standard_normal((40962, I, K))).to(
        cuda_device, dtype)
    kernels.reset_launch_counts()
    got = tinydot(w, x)
    assert kernels.launch_counts["tinydot"] == 1
    assert_close([got], [tinydot_plain(w, x)], rel)


@pytest.mark.cuda
def test_wrappers_refuse_bad_cuda_input(cuda_device):
    w = torch.zeros(8, 6, 6, device=cuda_device)
    x = torch.zeros(8, 6, 26, device=cuda_device)
    with pytest.raises(ValueError):
        tinydot(w, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        tinydot(w, x.double())
    with pytest.raises(TypeError):
        tinydot(w.half(), x.half())
