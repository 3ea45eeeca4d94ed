# Frozen copy of mpas_tpu_torch/constants.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Physical constants (same values as mpas_tpu/constants.py;
ref: src/framework/mpas_constants.F:25-37)."""

pii = 3.141592653589793          # pi
a = 6371229.0                    # spherical Earth radius [m]
omega = 7.29212e-5               # Earth angular rotation rate [s-1]
gravity = 9.80616                # acceleration due to gravity [m s-2]
rgas = 287.0                     # gas constant, dry air [J kg-1 K-1]
rv = 461.6                       # gas constant, water vapor [J kg-1 K-1]
rvord = rv / rgas
cp = 7.0 * rgas / 2.0            # specific heat, dry air, const pressure
cv = cp - rgas                   # specific heat, dry air, const volume
cvpm = -cv / cp
prandtl = 1.0
p0 = 1.0e5                       # reference pressure [Pa]
