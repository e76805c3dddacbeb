"""Bounce-ray coherence sorting for the wavefront path.

A sweep that culls triangle chunks per block of lanes (a chunk is tested
if ANY lane in the block wants it) works well on primary rays, which
arrive Z-order coherent, and degenerates on BOUNCE rays, which are
scattered over the whole scene after one diffuse reflection.

Fix, standard in wavefront GPU tracers: re-SORT the wavefront between
bounces so lanes that are spatially+directionally similar are adjacent
again. The key is (direction octant | origin Morton): within an octant
class, rays from the same surface patch march together. Dead lanes sort
to the END and their rays are PARKED far outside the scene bounds
pointing away — compaction without changing wavefront width. The
default ``intersect_triangles_mm`` sweep does not cull, so it gains
nothing from the order yet; a culled or BVH sweep would.

Correctness is permutation-transparency: every per-lane quantity (RNG key,
throughput, radiance) travels with its lane and the final radiance is
scattered back to the original lane order, so images are BITWISE equal
with sorting on or off (tests/test_integrators.py gates this). No
counterpart exists in the reference (its ``par_unseq`` threads are
per-pixel and never interact, Src/renderer.cpp:83-99); this is SIMD
scheduling, not an estimator change.
"""

import jax.numpy as jnp
import numpy as np

_DEAD_KEY = np.int32(0x7FFFFFFF)


def scene_bounds(scene):
    """(lo, hi) AABB over all valid primitives, as (3,) arrays. Runs under
    jit; tables are usually closed-over constants so XLA folds it."""
    big = jnp.float32(3.0e38)
    tm = (scene.tri_obj >= 0)[:, None]
    pts_lo = []
    pts_hi = []
    for p in (
        scene.tri_v0,
        scene.tri_v0 + scene.tri_e1,
        scene.tri_v0 + scene.tri_e2,
    ):
        pts_lo.append(jnp.where(tm, p, big).min(axis=0))
        pts_hi.append(jnp.where(tm, p, -big).max(axis=0))
    sm = (scene.sph_obj >= 0)[:, None]
    r = scene.sph_radius[:, None]
    pts_lo.append(jnp.where(sm, scene.sph_center - r, big).min(axis=0))
    pts_hi.append(jnp.where(sm, scene.sph_center + r, -big).max(axis=0))
    bm = (scene.box_obj >= 0)[:, None]
    pts_lo.append(jnp.where(bm, scene.box_min, big).min(axis=0))
    pts_hi.append(jnp.where(bm, scene.box_max, -big).max(axis=0))
    lo = jnp.min(jnp.stack(pts_lo), axis=0)
    hi = jnp.max(jnp.stack(pts_hi), axis=0)
    # degenerate/empty guard
    ok = hi >= lo
    lo = jnp.where(ok, lo, 0.0)
    hi = jnp.where(ok, hi, 1.0)
    return lo, hi


def _spread3(x):
    """Spread the low 9 bits of int32 ``x`` to every 3rd bit position."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_key(o, d, active, lo, inv_ext):
    """(N,) int32 sort key: direction octant (3 bits, major) | 27-bit
    Morton code of the origin quantized into the scene bounds. Dead lanes
    get the maximal key (sort last)."""
    q = jnp.clip((o - lo) * inv_ext * 511.0, 0.0, 511.0).astype(jnp.int32)
    m = (
        (_spread3(q[:, 0]) << 2)
        | (_spread3(q[:, 1]) << 1)
        | _spread3(q[:, 2])
    )
    octant = (
        (d[:, 0] < 0).astype(jnp.int32) * 4
        + (d[:, 1] < 0).astype(jnp.int32) * 2
        + (d[:, 2] < 0).astype(jnp.int32)
    )
    key = (octant << 27) | m
    return jnp.where(active, key, _DEAD_KEY)
