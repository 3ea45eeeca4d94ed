"""Atmosphere column physics (port of mpas_tpu/cores/atmosphere/physics):
so far the Kessler warm-rain scheme and its dycore coupling driver."""
