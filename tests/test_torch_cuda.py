"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

Shapes are those of the paths (jw_120km: 40,962 cells x 26 levels;
supercell_2km: 9,216 cells x 40 levels; jw_var60_15: 23,000 cells x 26
levels at maxEdges 8; sw_tc5_120km: 40,962 cells at K = 1 and 2).
Tolerances: float64 1e-12 x max|plain| (summation order only); float32
1e-5 for K1, whose Thomas recurrence amplifies differently contracted
FMAs, 1e-6 for K2.
"""

import numpy as np
import pytest
import torch

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                             acoustic_cell_update_plain,
                                             example_args)
from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain

# (nC, nz) per path, and K1 at jw_120km_nz55's 55 levels
PATHS = [(40962, 26), (9216, 40), (23000, 26), (40962, 55)]
# (nC, P, I, K) of the TRiSK and second-derivative contractions of the
# atmosphere paths (I = maxEdges), and the shallow-water TRiSK pair
K2_SHAPES = [(nc, P, mE, K) for nc, nz, mE in ((40962, 26, 6),
                                               (9216, 40, 6),
                                               (23000, 26, 8))
             for P, K in ((mE, nz), (mE, 2 * nz), (3, nz))] \
    + [(40962, 6, 6, 1), (40962, 6, 6, 2)]


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
    w = rng.standard_normal((nc, P, I))
    # zero-weight padded slots, as in the cells of a maxEdges-8 mesh that
    # have fewer than 8 edges
    pad = rng.uniform(size=(nc, 1, I)) < 0.3
    w = torch.from_numpy(np.where(pad, 0.0, w)).to(cuda_device, dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["tangential_cell_assembled",
                                "trisk_q_cell_assembled"])
def test_one_dimensional_trisk_goes_through_k2(cuda_device, op):
    """The shallow-water TRiSK operators of a 1-D edge field launch K2
    once (at K = 1 and K = 2) and agree with the CPU's plain path."""
    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
    from mpas_tpu_torch.ops import stencils

    mesh = icosahedral_mesh(8, lloyd_iters=1)
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.standard_normal(mesh.nEdges))
            for _ in range(1 if op == "tangential_cell_assembled" else 2)]
    fn = getattr(stencils, op)
    want = fn(mesh, *args)
    kernels.reset_launch_counts()
    got = fn(mesh.to(cuda_device, torch.float64),
             *[x.to(cuda_device) for x in args])
    assert kernels.launch_counts["tinydot"] == 1
    assert got.shape == want.shape == (mesh.nEdges,)
    assert_close([got.cpu()], [want], 1e-12)
