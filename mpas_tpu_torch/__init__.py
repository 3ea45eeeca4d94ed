"""PyTorch/CUDA port of mpas_tpu: so far the nonhydrostatic atmosphere
(the dry JW slice, also on a variable-resolution mesh, and the moist
supercell with its microphysics and physics suites), the shallow-water
core, the ocean's forward model (split-explicit and RK4), the distributed
runner, and the run driver with its command line,
`python -m mpas_tpu_torch <core>`.

Module paths and function names mirror `mpas_tpu` so each function's
reference twin is easy to find (`mpas_tpu_torch/cores/atmosphere/nhyd.py`
<-> `mpas_tpu/cores/atmosphere/nhyd.py`). Host setup is numpy/scipy; the
model state lives in torch tensors on an explicit device. The two Pallas
kernels of the reference are hand-written CUDA kernels here
(`csrc/`, bound in `kernels/`).
"""
