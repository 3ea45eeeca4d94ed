"""The port's kernel modules against the Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; that version is
held to the JAX package's Pallas kernel, run in interpret mode, on the same
seeded inputs (tolerance 1e-12 x max|ref|: float64, different summation
order only). The CUDA kernels themselves are held to the plain versions by
tests/test_torch_cuda.py on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.kernels.acoustic import acoustic_cell_update as jax_acoustic
from mpas_tpu.kernels.tinydot import tinydot as jax_tinydot
from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                             acoustic_cell_update_plain,
                                             example_args)
from mpas_tpu_torch.kernels.build import CSRC, _SIGNATURES
from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain

torch.set_num_threads(1)

REL = 1e-12
K2_SHAPES = [(6, 6, 26), (6, 6, 52), (3, 6, 26)]   # (P, I, K) on the path
K1_ORDER = ("rs_pre", "ts_pre", "rw_p0", "wwavg0", "tend_rw", "rho_pp0",
            "rtheta_pp0", "cofwz", "cofwr", "cofwt", "coftz", "cofrz", "rdzw",
            "a_tri", "alpha_tri", "gamma_tri", "zz", "dss_int", "dw_term",
            "wdamp")


def assert_close(got, ref, rel=REL):
    for g, r in zip(got, ref):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rel * np.abs(r).max()


@pytest.mark.parametrize("nz", [10, 26])
def test_acoustic_plain_matches_pallas_kernel(nz):
    nc = 700                       # not a multiple of the TPU block (512)
    a = example_args(nc, nz)
    ref = jax_acoustic(nz, 0.1, 120.0,
                       *[jnp.asarray(a[k]) for k in K1_ORDER], interpret=True)
    got = acoustic_cell_update_plain(
        nz, 0.1, 120.0, **{k: torch.from_numpy(v) for k, v in a.items()})
    assert_close(got, ref)


@pytest.mark.parametrize("P,I,K", K2_SHAPES)
def test_tinydot_plain_matches_pallas_kernel(P, I, K):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((700, P, I))
    x = rng.standard_normal((700, I, K))
    ref = jax_tinydot(jnp.asarray(w), jnp.asarray(x), interpret=True)
    got = tinydot_plain(torch.from_numpy(w), torch.from_numpy(x))
    assert_close([got], [ref])


def test_wrappers_use_plain_version_on_cpu():
    a = {k: torch.from_numpy(v) for k, v in example_args(64, 10).items()}
    kernels.reset_launch_counts()
    for g, r in zip(acoustic_cell_update(10, 0.1, 120.0, **a),
                    acoustic_cell_update_plain(10, 0.1, 120.0, **a)):
        assert torch.equal(g, r)
    w, x = torch.randn(64, 6, 6, dtype=torch.float64), \
        torch.randn(64, 6, 26, dtype=torch.float64)
    assert torch.equal(tinydot(w, x), tinydot_plain(w, x))
    assert kernels.launch_counts == {"acoustic_cell_update": 0, "tinydot": 0}


def test_wrappers_raise_off_cpu_and_cuda():
    w = torch.empty(4, 6, 6, device="meta")
    x = torch.empty(4, 6, 26, device="meta")
    with pytest.raises(ValueError):
        tinydot(w, x)
    a = {k: torch.empty(v.shape, device="meta")
         for k, v in example_args(4, 10).items()}
    with pytest.raises(ValueError):
        acoustic_cell_update(10, 0.1, 120.0, **a)


def test_cuda_sources_export_the_bound_entry_points():
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    exported = set(re.findall(r'extern "C" int (\w+)\(', text))
    assert exported == {n + s for n in _SIGNATURES for s in ("_f32", "_f64")}
    assert "sm_90a" in Path(CSRC.parent / "kernels" / "build.py").read_text()
