"""MPAS-Albany Land Ice equivalent core (port of mpas_tpu/cores/landice).

Capability parity targets (ref: src/core_landice/, SURVEY §2.4):
  time integration — forward Euler (mpas_li_time_integration_fe.F)
  velocity solvers — SIA (mpas_li_sia.F), first-order Stokes
                     (fo_stokes.py), the external FO-Stokes interface
                     (Interface_velocity_solver.cpp -> the C++ shim in
                     tools/velocity_solver/, external.py)
  advection        — centered / first-order upwind / incremental
                     remapping thickness transport (mpas_li_advection.F)
  thermal solver   — vertical temperature or enthalpy column solve
                     (mpas_li_thermal.F)
  calving          — thickness / floatation / topographic /
                     eigencalving criteria (mpas_li_calving.F)
  hydrology        — the subglacial sheet and channels
                     (mpas_li_subglacial_hydro.F)
"""
