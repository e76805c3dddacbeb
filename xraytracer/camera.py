"""Pinhole camera: batched primary-ray generation.

JAX counterpart of ``PinholeCamera::sampleRay`` (reference:
Src/camera.h:33-60): NDC direction ``((2u-1)s, (1-2v)s/aspect, -1)``
transformed by the row-vector camera-to-world matrix; origin is the matrix's
translation row; pdf is always 1.
"""

from typing import NamedTuple

import jax.numpy as jnp

from .constants import deg2rad
from .math import normalize, transform_dir
from .geometry.types import Rays


class PinholeCamera(NamedTuple):
    c2w: jnp.ndarray     # (4, 4) row-vector camera-to-world
    scale: jnp.ndarray   # tan(FOV/2)
    aspect: jnp.ndarray  # width / height

    @staticmethod
    def make(aspect_ratio, c2w, fov_deg=90.0):
        return PinholeCamera(
            c2w=jnp.asarray(c2w, jnp.float32),
            scale=jnp.float32(jnp.tan(0.5 * deg2rad(fov_deg))),
            aspect=jnp.float32(aspect_ratio),
        )

    def sample_rays(self, uv) -> Rays:
        """uv: (N, 2) sensor coords in [0,1]^2 -> wavefront of primary rays."""
        d = jnp.stack(
            [
                (2.0 * uv[:, 0] - 1.0) * self.scale,
                (1.0 - 2.0 * uv[:, 1]) * self.scale / self.aspect,
                -jnp.ones_like(uv[:, 0]),
            ],
            axis=-1,
        )
        d = normalize(transform_dir(self.c2w, d))
        o = jnp.broadcast_to(self.c2w[3, :3], d.shape)
        return Rays(o=o, d=d)
