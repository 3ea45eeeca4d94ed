"""Atmosphere column physics (port of mpas_tpu/cores/atmosphere/physics):
Kessler and WSM6 microphysics with their dycore coupling driver, and the
mesoscale_reference suite that manager.physics_step runs before the
dynamics (RRTMG-class and broadband radiation, cldfra3, the MM5 surface
layer, Noah and slab land surfaces, YSU, GWDO, new Tiedtke)."""
