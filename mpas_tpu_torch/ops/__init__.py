"""See the package docstring of mpas_tpu_torch."""
