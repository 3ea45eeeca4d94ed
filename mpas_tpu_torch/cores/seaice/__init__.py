"""MPAS-Seaice equivalent core (port of mpas_tpu/cores/seaice).

  velocity solver  EVP elastic subcycling, weak + variational
                   discretizations (mpas_seaice_velocity_solver*.F)
  advection        flux-form upwind or incremental-remap transport of the
                   ice-thickness-distribution tracer hierarchy
  column physics   zero-layer or multilayer (BL99, mushy) thermodynamics,
                   delta-Eddington shortwave, ponds, ITD remapping,
                   ridging and the tracer packages (column/ice_colpkg.F90
                   capability)
"""
