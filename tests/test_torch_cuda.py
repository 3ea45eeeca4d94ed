"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

Shapes are those of both paths (jw_120km: 40,962 cells x 26 levels;
supercell_2km: 9,216 cells x 40 levels). Tolerances: float64
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

PATHS = [(40962, 26), (9216, 40)]                   # (nC, nz) per path
# (nC, P, I, K) of the TRiSK and second-derivative contractions
K2_SHAPES = [(nc, P, 6, K) for nc, nz in PATHS
             for P, K in ((6, nz), (6, 2 * nz), (3, nz))]


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
@pytest.mark.parametrize("nc,nz", PATHS)
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_acoustic_kernel_matches_plain(cuda_device, nc, nz, dtype, rel):
    a = {k: torch.from_numpy(v).to(cuda_device, dtype)
         for k, v in example_args(nc, nz).items()}
    kernels.reset_launch_counts()
    got = acoustic_cell_update(nz, 0.1, 120.0, **a)
    assert kernels.launch_counts["acoustic_cell_update"] == 1
    assert_close(got, acoustic_cell_update_plain(nz, 0.1, 120.0, **a), rel)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,P,I,K", K2_SHAPES)
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_tinydot_kernel_matches_plain(cuda_device, nc, P, I, K, dtype, rel):
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((nc, P, I))).to(
        cuda_device, dtype)
    x = torch.from_numpy(rng.standard_normal((nc, I, K))).to(
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
