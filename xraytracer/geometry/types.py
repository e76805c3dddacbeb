"""Wavefront ray / hit records (struct-of-arrays).

JAX counterpart of the reference's per-ray ``Ray`` / ``SurfaceInfo`` /
``IntersectInfo`` structs (reference: Src/ray.h:5-39). A record holds a whole
wavefront: every field is an ``(N, ...)`` array and the ray index is the
batch dimension. ``IntersectInfo.t1`` (distance to medium exit,
Src/ray.h:35) is preserved as ``Hit.t1``.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import INF


class Rays(NamedTuple):
    o: jnp.ndarray  # (N, 3) origins
    d: jnp.ndarray  # (N, 3) unit directions

    @property
    def n(self):
        return self.o.shape[0]

    def at(self, t):
        """Point along each ray: o + t * d (reference: Src/ray.h:19)."""
        return self.o + t[..., None] * self.d


class Hit(NamedTuple):
    """Nearest-hit record for a wavefront. ``obj < 0`` means miss.

    The appearance fields (light/medium/mtype/ior/albedo) are pre-joined
    from the denormalized primitive records so integrators shade without
    further table gathers."""

    t: jnp.ndarray         # (N,) distance to hit (INF on miss)
    t1: jnp.ndarray        # (N,) medium exit distance (INF unless box hit)
    obj: jnp.ndarray       # (N,) int32 object id, -1 on miss
    position: jnp.ndarray  # (N, 3)
    ng: jnp.ndarray        # (N, 3) geometric normal
    ns: jnp.ndarray        # (N, 3) shading normal
    dpdu: jnp.ndarray      # (N, 3) tangent
    dpdv: jnp.ndarray      # (N, 3) bitangent
    uv: jnp.ndarray        # (N, 2) texcoords
    bary: jnp.ndarray      # (N, 2) barycentric (u, v)
    light: jnp.ndarray     # (N,) int32 area-light row, -1 = none
    medium: jnp.ndarray    # (N,) int32 medium row, -1 = none
    mtype: jnp.ndarray     # (N,) int32 material type id, -1 = none
    ior: jnp.ndarray       # (N,)
    albedo: jnp.ndarray    # (N, 3)

    @property
    def hit(self):
        return self.obj >= 0


def miss_hit(n, dtype=jnp.float32):
    z3 = jnp.zeros((n, 3), dtype)
    z2 = jnp.zeros((n, 2), dtype)
    neg1 = jnp.full((n,), -1, jnp.int32)
    return Hit(
        t=jnp.full((n,), INF, dtype),
        t1=jnp.full((n,), INF, dtype),
        obj=neg1,
        position=z3,
        ng=z3,
        ns=z3,
        dpdu=z3,
        dpdv=z3,
        uv=z2,
        bary=z2,
        light=neg1,
        medium=neg1,
        mtype=neg1,
        ior=jnp.ones((n,), dtype),
        albedo=z3,
    )
