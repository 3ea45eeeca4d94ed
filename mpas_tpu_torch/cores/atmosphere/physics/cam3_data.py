"""CAM3 radiation constant tables (vendored published coefficients; the
port's own copy of mpas_tpu/cores/atmosphere/physics/cam3_data.py, held to
it array by array in tests/test_torch_cam.py).

Sources (all published parameterizations; the numbers are the scheme's
defining constants, cited per block):

- 19-interval shortwave spectral data: Briegleb (1992, JGR 97) as updated
  for Hitran-2K/CKD-2.4 in CAM3; declarations at
  physics_wrf/module_ra_cam.F:82-196.
- Liquid cloud optics: Slingo (1989, JAS 46, 1419-1427) 4-band fit,
  module_ra_cam.F:5-24.
- Ice cloud optics: Ebert & Curry (1992, JGR 97, 3831-3836),
  module_ra_cam.F:39-56.
- Ice effective radius vs temperature: Kristjansson/Mitchell hexagonal
  column table, module_ra_cam_support.F:352-377.
- H2O 500-800 cm-1 band-model and e-type continuum coefficients:
  Ramanathan & Downey (1986, JGR 91, 8649-8666) / Kiehl & Briegleb,
  module_ra_cam_support.F:126-145 and :3815-3834.
- Planck band weights as U->inf (fat/fet): Collins/Hackney/Edwards CAM3
  fit, module_ra_cam_support.F:150-175.
- Trace-gas (CH4/N2O/CFC11/CFC12/CO2 minor bands) band models: Kiehl et
  al. CCM3/CAM3 description; module_ra_cam_support.F:436-720 (trcab),
  :1426-1516 (trcplk), :1518-1668 (trcpth).

These are data, not code: the scheme itself is in cam3.py and
cam_radiation.py.
"""

import numpy as np

# --------------------------------------------------------------------------
# Shortwave: 19 spectral intervals (module_ra_cam.F:102-196)
# --------------------------------------------------------------------------
NSPINT = 19

FRCSOL = np.array([.001488, .001389, .001290, .001686, .002877,
                   .003869, .026336, .360739, .065392, .526861,
                   .526861, .526861, .526861, .526861, .526861,
                   .526861, .006239, .001834, .001834])

# Nimbus-7 NIR filter weights (for the fsnirtoa diagnostic)
NIRWGT = np.array([0.0, 0.0, 0.0, 0.0, 0.0,
                   0.0, 0.0, 0.0, 0.320518, 1.0, 1.0,
                   1.0, 1.0, 1.0, 1.0, 1.0,
                   1.0, 1.0, 1.0])

WAVMIN = np.array([.200, .245, .265, .275, .285,
                   .295, .305, .350, .640, .700, .701,
                   .701, .701, .701, .702, .702,
                   2.630, 4.160, 4.160])

WAVMAX = np.array([.245, .265, .275, .285, .295,
                   .305, .350, .640, .700, 5.000, 5.000,
                   5.000, 5.000, 5.000, 5.000, 5.000,
                   2.860, 4.550, 4.550])

WAVMID = 0.5 * (WAVMIN + WAVMAX)

RAYTAU = np.array([4.020, 2.180, 1.700, 1.450, 1.250,
                   1.085, 0.730, 0.155208, 0.0392,
                   0.02899756, 0.01356763, 0.00537341,
                   0.00228515, 0.00105028, 0.00046631,
                   0.00025734, .0001, .0001, .0001])

# absorption coefficients, cm2/g
ABH2O = np.array([.000, .000, .000, .000, .000,
                  .000, .000, .000, .000,
                  0.00256608, 0.06310504, 0.42287445, 2.45397941,
                  11.20070807, 47.66091389, 240.19010243,
                  .000, .000, .000])

ABO3 = np.array([5.370e+04, 13.080e+04, 9.292e+04, 4.530e+04, 1.616e+04,
                 4.441e+03, 1.775e+02, 2.4058030e+01, 2.210e+01, .000,
                 .000, .000, .000, .000, .000,
                 .000, .000, .000, .000])

ABCO2 = np.array([.000, .000, .000, .000, .000,
                  .000, .000, .000, .000, .000,
                  .000, .000, .000, .000, .000,
                  .000, .094, .196, 1.963])

ABO2 = np.array([.000, .000, .000, .000, .000,
                 .000, .000, .000, 1.11e-05, 6.69e-05,
                 .000, .000, .000, .000, .000,
                 .000, .000, .000, .000])

# spectral-interval probability weights (k-distribution weights)
PH2O = np.array([.000, .000, .000, .000, .000,
                 .000, .000, .000, .000, .505,
                 .210, .120, .070, .048, .029,
                 .018, .000, .000, .000])

PCO2 = np.array([.000, .000, .000, .000, .000,
                 .000, .000, .000, .000, .000,
                 .000, .000, .000, .000, .000,
                 .000, 1.000, .640, .360])

PO2 = np.array([.000, .000, .000, .000, .000,
                .000, .000, .000, 1.000, 1.000,
                .000, .000, .000, .000, .000,
                .000, .000, .000, .000])

# psf = product of the nonzero weights (module_ra_cam.F:6304-6307)
PSF = np.ones(NSPINT)
for _arr in (PH2O, PCO2, PO2):
    PSF = np.where(_arr != 0.0, PSF * np.where(_arr != 0.0, _arr, 1.0), PSF)

# Slingo band index per interval (1..4 -> 0..3 here): by wavmid
# (module_ra_cam.F:6270-6288; the encoded .001/.002 wavmin offsets select
# NIR sub-bands for the 0.7-5.0 intervals)
INDXSL = np.empty(NSPINT, dtype=np.int64)
for _ns in range(NSPINT):
    wm = WAVMID[_ns]
    lo = WAVMIN[_ns]
    if wm < 0.7:
        INDXSL[_ns] = 0
    elif lo == 0.700:
        INDXSL[_ns] = 1
    elif lo == 0.701:
        INDXSL[_ns] = 2
    elif lo == 0.702 or wm > 2.38:
        INDXSL[_ns] = 3
    else:
        INDXSL[_ns] = 1

# Slingo (1989) liquid cloud optics, 4 bands
ABARL = np.array([2.817e-02, 2.682e-02, 2.264e-02, 1.281e-02])
BBARL = np.array([1.305, 1.346, 1.454, 1.641])
CBARL = np.array([-5.62e-08, -6.94e-06, 4.64e-04, 0.201])
DBARL = np.array([1.63e-07, 2.35e-05, 1.24e-03, 7.56e-03])
EBARL = np.array([0.829, 0.794, 0.754, 0.826])
FBARL = np.array([2.482e-03, 4.226e-03, 6.560e-03, 4.353e-03])

# Ebert & Curry (1992) ice cloud optics, 4 bands
ABARI = np.array([3.448e-03, 3.448e-03, 3.448e-03, 3.448e-03])
BBARI = np.array([2.431, 2.431, 2.431, 2.431])
CBARI = np.array([1.00e-05, 1.10e-04, 1.861e-02, .46658])
DBARI = np.array([0.0, 1.405e-05, 8.328e-04, 2.05e-05])
EBARI = np.array([0.7661, 0.7730, 0.794, 0.9595])
FBARI = np.array([5.851e-04, 5.665e-04, 7.267e-04, 1.076e-04])

# Rayleigh scattering single-scatter properties
WRAY = 0.999999
GRAY = 0.0
FRAY = 0.1

O2MMR = 0.23143
# stratospheric H2O path lower bound (pressure, atm) for the extra layer
DELTA_H2O = 0.0014257179260883

# ice effective radius (um) vs T: 180..274 K, 1-K steps
RETAB = np.array([
    5.92779, 6.26422, 6.61973, 6.99539, 7.39234,
    7.81177, 8.25496, 8.72323, 9.21800, 9.74075, 10.2930,
    10.8765, 11.4929, 12.1440, 12.8317, 13.5581, 14.2319,
    15.0351, 15.8799, 16.7674, 17.6986, 18.6744, 19.6955,
    20.7623, 21.8757, 23.0364, 24.2452, 25.5034, 26.8125,
    27.7895, 28.6450, 29.4167, 30.1088, 30.7306, 31.2943,
    31.8151, 32.3077, 32.7870, 33.2657, 33.7540, 34.2601,
    34.7892, 35.3442, 35.9255, 36.5316, 37.1602, 37.8078,
    38.4720, 39.1508, 39.8442, 40.5552, 41.2912, 42.0635,
    42.8876, 43.7863, 44.7853, 45.9170, 47.2165, 48.7221,
    50.4710, 52.4980, 54.8315, 57.4898, 60.4785, 63.7898,
    65.5604, 71.2885, 75.4113, 79.7368, 84.2351, 88.8833,
    93.6658, 98.5739, 103.603, 108.752, 114.025, 119.424,
    124.954, 130.630, 136.457, 142.446, 148.608, 154.956,
    161.503, 168.262, 175.248, 182.473, 189.952, 197.699,
    205.728, 214.055, 222.694, 231.661, 240.971, 250.639])

# --------------------------------------------------------------------------
# Longwave: H2O 500-800 cm-1 band model + window continuum (R&D 1986)
# --------------------------------------------------------------------------
# coefj/coefk: line absorption in the two 500-800 sub-bands
COEFJ = np.array([[2.82096e-02, 2.47836e-04, 1.16904e-06],
                  [9.27379e-02, 8.04454e-04, 6.88844e-06]])
COEFK = np.array([[2.48852e-01, 2.09667e-03, 2.60377e-06],
                  [1.03594e+00, 6.58620e-03, 4.04456e-06]])
# coefh: e-type continuum in 4 sub-windows
COEFH = np.array([[5.46557e+01, -7.30387e-02],
                  [1.09311e+02, -1.46077e-01],
                  [5.11479e+01, -6.82615e-02],
                  [1.02296e+02, -1.36523e-01]])

C16 = COEFJ[0, 2] / COEFJ[0, 1]
C17 = COEFK[0, 2] / COEFK[0, 1]
C26 = COEFJ[1, 2] / COEFJ[1, 1]
C27 = COEFK[1, 2] / COEFK[1, 1]
C28 = 0.5
C29 = 0.002053
C30 = 0.1
C31 = 3.0e-5
FWCOEF = 0.1     # R&D eq (33) far-wing correction
FWC1 = 0.30
FWC2 = 4.5
FC1 = 2.6

# Planck band fractions as U->inf: band 0 = 0-800 & 1200-2200 cm-1
# ("non-window"), band 1 = 800-1200 cm-1 ("window"); poly in T_e
FAT = np.array([
    [-1.06665373E-01, 2.90617375E-02, -2.70642049E-04,
     1.07595511E-06, -1.97419681E-09, 1.37763374E-12],
    [1.10666537E+00, -2.90617375E-02, 2.70642049E-04,
     -1.07595511E-06, 1.97419681E-09, -1.37763374E-12]])
FET = np.array([
    [3.46148163E-01, 1.51240299E-02, -1.21846479E-04,
     4.04970123E-07, -6.15368936E-10, 3.52415071E-13],
    [6.53851837E-01, -1.51240299E-02, 1.21846479E-04,
     -4.04970123E-07, 6.15368936E-10, -3.52415071E-13]])

# --------------------------------------------------------------------------
# Trace gases: H2O overlap transmission factors for 6 sub-windows
# (750-820, 820-880, 880-900, 900-1000, 1000-1120, 1120-1170 cm-1),
# module_ra_cam_support.F:556-567
# --------------------------------------------------------------------------
TG_G1 = np.array([0.0468556, 0.0397454, 0.0407664,
                  0.0304380, 0.0540398, 0.0321962])
TG_G2 = np.array([14.4832, 4.30242, 5.23523, 3.25342, 0.698935, 16.5599])
TG_G3 = np.array([26.1898, 18.4476, 15.3633, 12.1927, 9.14992, 8.07092])
TG_G4 = np.array([0.0261782, 0.0369516, 0.0307266,
                  0.0243854, 0.0182932, 0.0161418])
TG_AB = np.array([3.0857e-2, 2.3524e-2, 1.7310e-2,
                  2.6661e-2, 2.8074e-2, 2.2915e-2])
TG_BB = np.array([-1.3512e-4, -6.8320e-5, -3.2609e-5,
                  -1.0228e-5, -9.5743e-5, -1.0304e-4])
TG_ABP = np.array([2.9129e-2, 2.4101e-2, 1.9821e-2,
                   2.6904e-2, 2.9458e-2, 1.9892e-2])
TG_BBP = np.array([-1.3139e-4, -5.5688e-5, -4.6380e-5,
                   -8.0362e-5, -1.0115e-4, -8.8061e-5])

# Planck factors for the 14 trace-gas band centers (trcplk)
TG_F1 = np.array([5.85713e8, 7.94950e8, 1.47009e9, 1.40031e9, 1.34853e8,
                  1.05158e9, 3.35370e8, 3.99601e8, 5.35994e8, 8.42955e8,
                  4.63682e8, 5.18944e8, 8.83202e8, 1.03279e9])
TG_F2 = np.array([2.02493e11, 3.04286e11, 6.90698e11, 6.47333e11,
                  2.85744e10, 4.41862e11, 9.62780e10, 1.21618e11,
                  1.79905e11, 3.29029e11, 1.48294e11, 1.72315e11,
                  3.50140e11, 4.31364e11])
TG_F3 = np.array([1383.0, 1531.0, 1879.0, 1849.0, 848.0, 1681.0,
                  1148.0, 1217.0, 1343.0, 1561.0, 1279.0, 1328.0,
                  1586.0, 1671.0])

# cloud LW mass absorption (cldems, module_ra_cam_support.F:2097-2150)
KABSL = 0.090361         # liquid, m2/g
LW_DIFF = 1.66           # diffusivity factor

# CGS physical constants used by the band models
GRAVIT_CGS = 980.616          # cm/s2
SSLP_CGS = 1.013250e6         # dyn/cm2
STEBOL_CGS = 5.67e-5          # erg/cm2/s/K4
EPSILO = 0.622
AMCO2, AMD, AMO = 44.0, 28.9644, 48.0
