"""The host side of the port's tiled kernels: byte counts and tile planners.

The CUDA kernels run only on the card (tests/test_torch_cuda.py), but what
each wrapper decides before a launch is plain Python: how many values a
call must move (the bound that chip_smoke.py measures each kernel against)
and the tile of columns or cells, threads and shared memory of each block.
These tests hold the counts to hand counts and the plans to what an H100
block can take; the launchers on the card refuse a plan whose shared
memory is not their kernel's layout (tests/test_torch_cuda.py).
"""

import pytest

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels import acoustic, tinydot, vmix

# (P, I, K) of every path's contractions: jw_120km, supercell_2km,
# jw_var60_15 (TRiSK at nz and 2*nz, second derivatives at nz), the
# shallow-water TRiSK pair, and the ocean channel's K = 1, 20 and 40
K2_PATH_SHAPES = [(6, 6, 26), (6, 6, 52), (3, 6, 26), (6, 6, 40), (6, 6, 80),
                  (3, 6, 40), (8, 8, 26), (8, 8, 52), (3, 8, 26), (6, 6, 1),
                  (6, 6, 2), (6, 6, 20)]


@pytest.mark.parametrize("nz,values", [(26, 586), (55, 1224)])
def test_acoustic_values_per_column_hand_count(nz, values):
    # 6 level inputs, 12 interface inputs, 2 level and 2 interface outputs
    assert acoustic.values_per_column(nz) == values
    assert acoustic.bytes_moved(40962, nz, 4) == 4 * (40962 * values
                                                      + 2 * nz)


def test_tinydot_values_per_cell_hand_count():
    # w 6*6, x 6*52, out 6*52
    assert tinydot.values_per_cell(6, 6, 52) == 660
    assert tinydot.bytes_moved(40962, 6, 6, 52, 4) == 40962 * 660 * 4
    assert tinydot.operations(40962, 6, 6, 52) == 40962 * 6 * 52 * 11


def test_acoustic_operations_grow_with_levels():
    assert acoustic.operations(1, 26) == 18 * 26 + 45 * 25
    assert acoustic.operations(40962, 55) > 2 * acoustic.operations(40962, 26)


def check_tile(cols, threads, smem, expected_smem):
    assert cols >= 1
    assert cols <= 8 or cols % 8 == 0
    assert smem == expected_smem <= kernels.SMEM_LIMIT
    assert 32 <= threads <= 256 and threads % 32 == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_acoustic_plan_fits_every_level_count(itemsize):
    for nz in range(2, 129):
        cols, threads, smem = acoustic.plan(nz, itemsize)
        check_tile(cols, threads, smem,
                   acoustic.smem_bytes(cols, nz, itemsize))
        assert threads >= cols          # one thread per column in the sweeps
        assert cols == acoustic.MAX_COLS or \
            smem <= acoustic.SMEM_BUDGET < acoustic.smem_bytes(
                cols + (8 if cols >= 8 else 1), nz, itemsize)


@pytest.mark.parametrize("nz,itemsize,cols", [(26, 4, 16), (55, 4, 8),
                                              (55, 8, 4), (128, 8, 1),
                                              (500, 8, 1)])
def test_acoustic_plan_shrinks_the_tile(nz, itemsize, cols):
    assert acoustic.plan(nz, itemsize)[0] == cols


def test_acoustic_plan_refuses_what_no_block_takes():
    with pytest.raises(ValueError):
        acoustic.plan(1, 4)
    # one float64 column of 5,000 levels needs 280 KB
    with pytest.raises(ValueError):
        acoustic.plan(5000, 8)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P,I,K", K2_PATH_SHAPES)
def test_tinydot_plan_fits_every_path_shape(P, I, K, itemsize):
    cols, threads, smem = tinydot.plan(P, I, K, itemsize)
    check_tile(cols, threads, smem,
               tinydot.smem_bytes(cols, P, I, K, itemsize))
    assert smem <= tinydot.SMEM_BUDGET
    assert cols == tinydot.MAX_COLS or \
        tinydot.smem_bytes(cols + 8, P, I, K, itemsize) > tinydot.SMEM_BUDGET
    # the w tile is padded to 16 bytes, so the x tile starts aligned
    assert (smem - cols * I * K * itemsize) % 16 == 0


def test_tinydot_plan_examples():
    # (6, 6, 52) f32: 16 cells take 21.75 KB, and 32 would take 44.5 KB
    assert tinydot.plan(6, 6, 52, 4) == (16, 256, 22272)
    assert tinydot.smem_bytes(32, 6, 6, 52, 4) == 44544
    # K = 1: the tile stops at MAX_COLS cells, one thread per cell
    assert tinydot.plan(6, 6, 1, 4) == (32, 32, 5376)
    # (6, 6, 80) f64: the budget cuts the tile below 8 cells
    assert tinydot.plan(6, 6, 80, 8) == (5, 256, 20640)


def test_tinydot_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tinydot.plan(6, tinydot.MAX_I + 1, 26, 4)
    with pytest.raises(ValueError):
        tinydot.plan(6, 6, 10000, 8)     # one cell's x is 480 KB


@pytest.mark.parametrize("n,nz,ntr,values", [(40962, 60, 12, 1619),
                                             (122880, 60, 1, 299),
                                             (6336, 20, 2, 139)])
def test_vmix_values_per_column_hand_count(n, nz, ntr, values):
    # the field read and written (2 nz ntr), h and the mask (nz each) and
    # the nz - 1 inner-interface diffusivities
    assert vmix.bytes_moved(n, nz, ntr, 4) == 4 * n * values


@pytest.mark.parametrize("n,nz,ntr,values", [(6336, 20, 2, 119),
                                             (19072, 20, 1, 79)])
def test_vmix_values_per_column_hand_count_without_a_mask(n, nz, ntr,
                                                          values):
    # the channel's grid has no level mask: the field read and written,
    # h (nz) and the nz - 1 inner-interface diffusivities
    assert vmix.bytes_moved(n, nz, ntr, 4, masked=False) == 4 * n * values


@pytest.mark.parametrize("nz,ntr,itemsize,plan", [
    (60, 12, 4, (8, 128, 29696)), (60, 1, 4, (24, 128, 23040)),
    (20, 2, 4, (24, 128, 12096)), (60, 12, 8, (4, 128, 29376))])
def test_vmix_plan_examples(nz, ntr, itemsize, plan):
    assert vmix.plan(nz, ntr, itemsize) == plan


@pytest.mark.parametrize("nz,ntr", [(0, 1), (129, 1), (60, 0)])
def test_vmix_plan_refuses_what_the_kernel_does_not_take(nz, ntr):
    with pytest.raises(ValueError):
        vmix.plan(nz, ntr, 4)
