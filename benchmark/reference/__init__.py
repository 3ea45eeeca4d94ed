"""The plain reference of the benchmark's check: frozen copies of the
port's modules that the benchmark's configurations run (imports
rewritten into this package, the two hand kernels as plain PyTorch in
ops/plain.py, the dry core and the unsharded statistics only). It imports
nothing of mpas_tpu_torch, mpas_tpu or jax, and takes nothing the program
has made: it builds its own grids, tables and initial states from the
mesh file and the seeded inputs."""
