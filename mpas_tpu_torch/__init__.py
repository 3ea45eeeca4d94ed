"""PyTorch/CUDA port of the mpas_tpu dry nonhydrostatic atmosphere slice.

Module paths and function names mirror `mpas_tpu` so each function's
reference twin is easy to find (`mpas_tpu_torch/cores/atmosphere/nhyd.py`
<-> `mpas_tpu/cores/atmosphere/nhyd.py`). Host setup is numpy/scipy; the
model state lives in torch tensors on an explicit device. The two Pallas
kernels of the reference are hand-written CUDA kernels here
(`csrc/`, bound in `kernels/`).
"""
