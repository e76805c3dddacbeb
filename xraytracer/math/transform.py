"""4x4 homogeneous transforms, row-vector convention.

Counterpart of the reference's ``Matrix44`` (reference:
Src/geometry.h:281-590). The reference stores matrices row-major and
transforms ROW vectors: ``p' = p @ M`` with the translation in row 3
(Src/geometry.h:466-478 ``multVecMatrix``, :487-498 ``multDirMatrix``).
We keep the identical convention so the reference scenes' hard-coded
camera/light matrices can be used verbatim. Products ask for
``Precision.HIGHEST``: camera rays must not be built in TF32.
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

_HI = lax.Precision.HIGHEST


def identity(dtype=jnp.float32):
    return jnp.eye(4, dtype=dtype)


def from_rows(*rows):
    """Build a 4x4 from 16 scalars or 4 row-vectors, matching the reference
    constructor argument order (Src/geometry.h:292-312)."""
    flat = np.asarray(rows, dtype=np.float32).reshape(4, 4)
    return jnp.asarray(flat)


def transform_point(m, p):
    """Point transform with perspective divide
    (reference: Src/geometry.h:466-478 ``multVecMatrix``)."""
    r = jnp.matmul(p, m[:3, :3], precision=_HI) + m[3, :3]
    w = jnp.matmul(p, m[:3, 3], precision=_HI) + m[3, 3]
    return r / jnp.where(w == 0.0, 1.0, w)[..., None]


def transform_dir(m, d):
    """Direction transform, no translation
    (reference: Src/geometry.h:487-498 ``multDirMatrix``)."""
    return jnp.matmul(d, m[:3, :3], precision=_HI)


def inverse(m):
    """Matrix inverse (reference Gauss-Jordan: Src/geometry.h:509-590)."""
    return jnp.linalg.inv(m)


def translation(t):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = np.asarray(t, dtype=np.float32)
    return jnp.asarray(m)


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Build a camera-to-world matrix (row-vector convention) for a right-
    handed camera looking down -z, convenience not present in the reference."""
    eye = np.asarray(eye, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = true_up
    m[2, :3] = -fwd
    m[3, :3] = eye
    return jnp.asarray(m)
