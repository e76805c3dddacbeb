"""Batched 3-vector math on ``(..., 3)`` arrays.

JAX counterpart of the reference's scalar ``Vec3``/optics utilities
(reference: Src/geometry.h:135-268, Src/geometry.cpp:23-89). Everything here
is shape-polymorphic over leading batch dimensions and jit/vmap/grad-safe;
there are no data-dependent branches (``jnp.where`` everywhere).
"""

import jax.numpy as jnp


def dot(a, b):
    """Batched dot product over the trailing axis, keeps no dims. -> (...,)"""
    return jnp.sum(a * b, axis=-1)


def dot_keep(a, b):
    """Batched dot product, keepdims. -> (..., 1)"""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(v):
    return jnp.sqrt(dot(v, v))


def length2(v):
    return dot(v, v)


def normalize(v, eps=0.0):
    """v / |v|. With eps=0 this matches the reference exactly (can produce
    inf/nan on zero vectors, as the C++ does)."""
    n = length(v)[..., None]
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def vmin(a, b):
    return jnp.minimum(a, b)


def vmax(a, b):
    return jnp.maximum(a, b)


def orthonormal_basis(n):
    """Branchless (Pixar) ONB construction around unit normal ``n``.

    Returns (t, b) tangent/bitangent, matching the reference's active branch
    (reference: Src/geometry.cpp:43-48, the ``#else`` Duff et al. variant).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.copysign(jnp.ones_like(nz), nz)
    a = -1.0 / (sign + nz)
    c = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * c, -sign * nx], axis=-1)
    b = jnp.stack([c, sign + ny * ny * a, -ny], axis=-1)
    return t, b


def reflect(i, n):
    """Mirror reflection of incident direction ``i`` about normal ``n``
    (reference: Src/geometry.cpp:52-55)."""
    return i - 2.0 * dot_keep(i, n) * n


def refract(i, n, ior):
    """Snell refraction with total-internal-reflection -> zero vector
    (reference: Src/geometry.cpp:57-67). ``ior`` may be scalar or (...,)."""
    cosi = jnp.clip(dot(i, n), -1.0, 1.0)
    ior = jnp.broadcast_to(jnp.asarray(ior, i.dtype), cosi.shape)
    entering = cosi < 0.0
    etai = jnp.where(entering, 1.0, ior)
    etat = jnp.where(entering, ior, 1.0)
    nn = jnp.where(entering[..., None], n, -n)
    cosi = jnp.abs(cosi)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta[..., None] * i + (eta * cosi - jnp.sqrt(jnp.maximum(k, 0.0)))[
        ..., None
    ] * nn
    return jnp.where((k < 0.0)[..., None], jnp.zeros_like(i), refr)


def fresnel(i, n, ior):
    """Unpolarized Fresnel reflectance kr (reference: Src/geometry.cpp:69-89).

    Returns kr in [0, 1]; kr == 1 on total internal reflection.
    """
    cosi = jnp.clip(dot(i, n), -1.0, 1.0)
    ior = jnp.broadcast_to(jnp.asarray(ior, i.dtype), cosi.shape)
    exiting = cosi > 0.0
    etai = jnp.where(exiting, ior, 1.0)
    etat = jnp.where(exiting, 1.0, ior)
    sint = etai / etat * jnp.sqrt(jnp.maximum(0.0, 1.0 - cosi * cosi))
    cost = jnp.sqrt(jnp.maximum(0.0, 1.0 - sint * sint))
    cosa = jnp.abs(cosi)
    rs = (etat * cosa - etai * cost) / (etat * cosa + etai * cost)
    rp = (etai * cosa - etat * cost) / (etai * cosa + etat * cost)
    kr = 0.5 * (rs * rs + rp * rp)
    return jnp.where(sint >= 1.0, jnp.ones_like(kr), kr)


def world_to_local(v, lx, ly, lz):
    """Direction from world into the (lx, ly, lz) frame
    (reference: Src/geometry.h:686-691)."""
    return jnp.stack([dot(v, lx), dot(v, ly), dot(v, lz)], axis=-1)


def local_to_world(v, lx, ly, lz):
    """Direction from the (lx, ly, lz) frame into world
    (reference: Src/geometry.h:694-701)."""
    return (
        v[..., 0:1] * lx + v[..., 1:2] * ly + v[..., 2:3] * lz
    )
