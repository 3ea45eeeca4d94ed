"""init_atmosphere core equivalent: IC preprocessing toolchain (port of
mpas_tpu/cores/init_atmosphere).

ref: src/core_init_atmosphere/ (SURVEY §2.4): idealized cases live with
the atmosphere core (init_jw, init_supercell); this package carries the
real-data preprocessing machinery: map projections (mpas_init_atm_llxy.F),
horizontal interpolation (mpas_init_atm_hinterp.F), vertical interpolation
(mpas_init_atm_vinterp.F), static/terrain field interpolation from
geogrid tiles (mpas_init_atm_static.F + read_geogrid.c, read here in
numpy), the GWD statics (mpas_init_atm_gwd.F), the real-data case 7
(real_case) and the surface-update and LBC cases 8 and 9 (surface_lbc).
All of it runs once on the host in numpy; init_real returns CPU tensors.
"""
