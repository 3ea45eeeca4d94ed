"""Atmosphere column physics (port of mpas_tpu/cores/atmosphere/physics):
Kessler, WSM6 and Thompson microphysics with their dycore coupling
driver, and the suites that manager.physics_step runs before the dynamics
(RRTMG-class, CAM and broadband radiation with the ozone climatology,
cldfra3, the MM5 and MYNN surface layers, Noah and slab land surfaces,
YSU and MYNN PBLs, GWDO, new Tiedtke, Grell-Freitas, Kain-Fritsch); the
radar reflectivity, slab ocean mixed layer and urban canopy schemes."""
