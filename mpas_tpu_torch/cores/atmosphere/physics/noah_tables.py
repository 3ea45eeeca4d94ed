"""Noah LSM soil/vegetation parameter tables (port of
mpas_tpu/cores/atmosphere/physics/noah_tables.py).

ref capability: the SOILPARM.TBL (STATSGO 19 soil classes) and
VEGPARM.TBL (USGS 24-category land use) the reference Noah reads at init
(module_sf_noahlsm.F SOILPARM/VEGPARM blocks; the published WRF/Noah
parameter values, kept here as numpy constants).

Soil columns: BB (Clapp-Hornberger b), SMCMAX (porosity), SMCREF (field
capacity), SMCWLT (wilting point), SATDK (saturated hydraulic
conductivity m/s), QTZ (quartz fraction, for Johansen conductivity).
Vegetation columns: Z0 (roughness m), RSMIN (minimum stomatal
resistance s/m), LAI, ALBEDO, NROOT (rooting layers of the 4),
SHDFAC (green vegetation fraction).
"""

from __future__ import annotations

import numpy as np
import torch

# STATSGO 19 soil categories, 1-based (index 0 unused):
# 1 sand, 2 loamy sand, 3 sandy loam, 4 silt loam, 5 silt, 6 loam,
# 7 sandy clay loam, 8 silty clay loam, 9 clay loam, 10 sandy clay,
# 11 silty clay, 12 clay, 13 organic, 14 water, 15 bedrock,
# 16 other(land-ice), 17 playa, 18 lava, 19 white sand
#               BB     SMCMAX  SMCREF  SMCWLT  SATDK      QTZ
_SOIL = np.array([
    [0.00,  0.000,  0.000,  0.000,  0.0,       0.00],   # pad
    [2.79,  0.339,  0.236,  0.010,  1.07e-6,   0.92],   # sand
    [4.26,  0.421,  0.383,  0.028,  1.41e-5,   0.82],   # loamy sand
    [4.74,  0.434,  0.383,  0.047,  5.23e-6,   0.60],   # sandy loam
    [5.33,  0.476,  0.360,  0.084,  2.81e-6,   0.25],   # silt loam
    [5.33,  0.476,  0.383,  0.084,  2.81e-6,   0.10],   # silt
    [5.25,  0.439,  0.329,  0.066,  3.38e-6,   0.40],   # loam
    [6.66,  0.404,  0.315,  0.067,  4.45e-6,   0.60],   # sandy clay loam
    [8.72,  0.464,  0.387,  0.120,  2.04e-6,   0.10],   # silty clay loam
    [8.17,  0.465,  0.382,  0.103,  2.45e-6,   0.35],   # clay loam
    [10.73, 0.406,  0.338,  0.100,  7.22e-6,   0.52],   # sandy clay
    [10.39, 0.468,  0.404,  0.126,  1.34e-6,   0.10],   # silty clay
    [11.55, 0.468,  0.412,  0.138,  9.74e-7,   0.25],   # clay
    [5.25,  0.439,  0.329,  0.066,  3.38e-6,   0.05],   # organic
    [0.00,  1.000,  1.000,  0.000,  0.0,       0.00],   # water
    [2.79,  0.200,  0.170,  0.004,  1.41e-4,   0.60],   # bedrock
    [4.26,  0.421,  0.283,  0.028,  1.41e-5,   0.52],   # other/land-ice
    [11.55, 0.468,  0.454,  0.030,  9.74e-7,   0.10],   # playa
    [2.79,  0.200,  0.170,  0.004,  1.41e-4,   0.00],   # lava
    [2.79,  0.339,  0.236,  0.010,  1.07e-6,   0.92],   # white sand
])

# USGS 24-category land use, 1-based:
# 1 urban, 2 dry crop, 3 irr crop, 4 mixed crop, 5 crop/grass,
# 6 crop/wood, 7 grassland, 8 shrubland, 9 mixed shrub/grass,
# 10 savanna, 11 decid broadleaf, 12 decid needle, 13 evergreen broad,
# 14 evergreen needle, 15 mixed forest, 16 water, 17 herb wetland,
# 18 wooded wetland, 19 barren, 20 herb tundra, 21 wooded tundra,
# 22 mixed tundra, 23 bare tundra, 24 snow/ice
#               Z0     RSMIN   LAI   ALB    NROOT SHDFAC
_VEG = np.array([
    [0.00,   0.0,   0.0,  0.00,  0,    0.00],   # pad
    [0.80,  200.0,  1.0,  0.15,  1,    0.10],   # urban
    [0.15,   40.0,  3.0,  0.17,  3,    0.80],   # dryland crop
    [0.10,   40.0,  3.0,  0.18,  3,    0.80],   # irrigated crop
    [0.15,   40.0,  3.0,  0.18,  3,    0.80],   # mixed crop
    [0.14,   40.0,  2.5,  0.18,  3,    0.60],   # crop/grass
    [0.20,   70.0,  3.0,  0.16,  3,    0.60],   # crop/wood
    [0.12,   40.0,  2.0,  0.19,  3,    0.80],   # grassland
    [0.05,  300.0,  1.5,  0.22,  2,    0.70],   # shrubland
    [0.06,  170.0,  2.0,  0.20,  3,    0.70],   # mixed shrub/grass
    [0.15,   70.0,  2.5,  0.20,  3,    0.50],   # savanna
    [0.80,  100.0,  4.0,  0.16,  4,    0.80],   # decid broadleaf
    [0.85,  150.0,  4.0,  0.14,  4,    0.70],   # decid needleleaf
    [2.65,  150.0,  5.0,  0.12,  4,    0.95],   # evergreen broadleaf
    [1.09,  125.0,  5.0,  0.12,  4,    0.70],   # evergreen needleleaf
    [0.80,  125.0,  4.0,  0.13,  4,    0.80],   # mixed forest
    [0.001, 100.0,  0.0,  0.08,  0,    0.00],   # water
    [0.04,   40.0,  2.0,  0.14,  2,    0.60],   # herb wetland
    [0.05,  100.0,  4.0,  0.14,  2,    0.60],   # wooded wetland
    [0.01,  999.0,  0.5,  0.25,  1,    0.01],   # barren
    [0.04,  150.0,  1.0,  0.15,  3,    0.60],   # herb tundra
    [0.06,  150.0,  1.0,  0.15,  3,    0.60],   # wooded tundra
    [0.05,  150.0,  1.0,  0.15,  3,    0.60],   # mixed tundra
    [0.03,  200.0,  0.5,  0.25,  2,    0.30],   # bare tundra
    [0.001, 999.0,  0.0,  0.55,  1,    0.00],   # snow/ice
])

SOIL_NAMES = ("pad", "sand", "loamy_sand", "sandy_loam", "silt_loam",
              "silt", "loam", "sandy_clay_loam", "silty_clay_loam",
              "clay_loam", "sandy_clay", "silty_clay", "clay", "organic",
              "water", "bedrock", "other", "playa", "lava", "white_sand")


def _rows(table, idx, hi, dtype):
    """Rows of `table` for the 1-based class indices idx (a tensor, clipped
    to 1..hi), on idx's device in `dtype`."""
    t = torch.as_tensor(table, dtype=dtype, device=idx.device)
    return t[torch.clamp(idx.long(), 1, hi)]


def soil_params(isltyp, dtype=torch.float64):
    """Per-cell soil parameters from the STATSGO class index (1-19).
    Returns a dict of (nC,) tensors: bb, smcmax, smcref, smcwlt, satdk,
    qtz."""
    row = _rows(_SOIL, isltyp, 19, dtype)
    return {"bb": row[..., 0], "smcmax": row[..., 1],
            "smcref": row[..., 2], "smcwlt": row[..., 3],
            "satdk": row[..., 4], "qtz": row[..., 5]}


def veg_params(ivgtyp, dtype=torch.float64):
    """Per-cell vegetation parameters from the USGS class index (1-24)."""
    row = _rows(_VEG, ivgtyp, 24, dtype)
    return {"z0": row[..., 0], "rsmin": row[..., 1], "lai": row[..., 2],
            "albedo": row[..., 3], "nroot": row[..., 4],
            "shdfac": row[..., 5]}
