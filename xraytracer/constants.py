"""Numeric constants shared across the framework.

JAX counterpart of the reference's compile-time constants
(reference: Src/geometry.h:10-23 and Src/cmakelists.txt:61-62, where
``kEpsilon``/``kInfinity`` are CMake compile definitions).
"""

import numpy as np

PI = 3.14159265359
PI_MUL_2 = 2.0 * PI
PI_MUL_4 = 4.0 * PI
PI_DIV_2 = 0.5 * PI
PI_DIV_4 = 0.25 * PI
PI_INV = 1.0 / PI
PI_MUL_2_INV = 1.0 / PI_MUL_2
PI_MUL_4_INV = 1.0 / PI_MUL_4

# Ray offset used when re-originating rays at medium boundaries
# (reference: Src/geometry.h:23 ``RAY_EPS = 1e-3f``).
RAY_EPS = 1e-3

# Intersection epsilon (reference: kEpsilon=FLT_EPSILON, Src/cmakelists.txt:61).
K_EPS = float(np.finfo(np.float32).eps)

# "Infinite" distance sentinel (reference: kInfinity=FLT_MAX).
INF = float(np.finfo(np.float32).max)

# Shadow-ray origin bias used by the surface integrators
# (reference: Src/integrator.h:104,260 ``bias = 0.01f``).
SHADOW_BIAS = 0.01


def rad2deg(rad):
    return 180.0 * rad / PI


def deg2rad(deg):
    return deg / 180.0 * PI
