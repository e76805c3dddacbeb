"""Batched ray-scene intersection.

Wavefront counterpart of the reference's per-ray virtual ``intersect``
dispatch (reference: Src/scene.cpp:190-211 looping ``Object::intersect``,
Src/primitive.cpp:83-168 Möller-Trumbore, Src/primitive.h:106-177 sphere,
Src/primitive.h:243-268 box slab). Instead of a loop over objects, the scene
is three flat tables (triangles / spheres / medium boxes) and the whole
wavefront is tested against each table with masked min-reductions.

Deliberate divergences from the reference (SURVEY.md §2.4):
  * Box hits compete on nearest-t like everything else. (The C++ BoxMesh
    overwrites ``info`` unconditionally and its ``occluded`` returns true for
    every ray, Src/primitive.h:243-268 — order-dependent and wrong for mixed
    scenes.) Medium-only boxes never occlude shadow rays here.
  * Sphere hits get a proper ONB for (dpdu, dpdv). (The C++ leaves them
    uninitialized for spheres, Src/primitive.h:106-124.)

``intersect_triangles`` is the semantics-defining reference sweep;
``intersect_triangles_mm`` is the default sweep of every pipeline. Every
float32 contraction here asks for ``Precision.HIGHEST``: on GPUs XLA may
otherwise run it in TF32 (about three decimal digits), which flips hit and
miss decisions.
"""


import jax.numpy as jnp
from jax import lax

from ..constants import INF, K_EPS
from ..math import cross, dot, normalize, orthonormal_basis
from .types import Hit, Rays

# Triangle-table chunk processed per scan step: bounds peak memory at
# N_rays * TRI_CHUNK intermediates.
TRI_CHUNK = 128
_HI = lax.Precision.HIGHEST


def _tri_chunk_hits(o, d, v0, e1, e2, valid, culling=False):
    """Möller-Trumbore for one (C,)-triangle chunk against (N,) rays.

    Mirrors Src/primitive.cpp:140-168: with ``culling`` (the reference's
    optional CULLING compile define) backfaces (det < kEpsilon) miss;
    otherwise parallel rays miss on |det| < kEpsilon. Hits require
    t > kEpsilon. Returns (t, u, v, ok) each (N, C).
    """
    dN = d[:, None, :]
    pvec = cross(dN, e2[None, :, :])                    # (N, C, 3)
    det = jnp.einsum("cj,ncj->nc", e1, pvec, precision=_HI)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.einsum("ncj,ncj->nc", tvec, pvec, precision=_HI) * inv_det
    qvec = cross(tvec, e1[None, :, :])
    v = jnp.einsum("ncj,ncj->nc", dN, qvec, precision=_HI) * inv_det
    t = jnp.einsum("cj,ncj->nc", e2, qvec, precision=_HI) * inv_det
    det_ok = (det >= K_EPS) if culling else (jnp.abs(det) >= K_EPS)
    ok = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > K_EPS)
        & valid[None, :]
    )
    return t, u, v, ok


def intersect_triangles(rays: Rays, v0, e1, e2, valid, chunk=TRI_CHUNK,
                        culling=False):
    """Nearest triangle hit per ray. Tables must be padded to a multiple of
    ``chunk`` (builder guarantees this). Returns (t, idx, u, v); t=INF and
    idx=-1 on miss."""
    n = rays.o.shape[0]
    t_total = v0.shape[0]
    chunk = min(chunk, t_total)
    n_chunks = t_total // chunk if chunk else 0

    def _v0():
        return (
            jnp.full((n,), INF),
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,)),
            jnp.zeros((n,)),
        )

    def step(carry, ci):
        bt, bi, bu, bv = carry
        s = ci * chunk
        cv0 = lax.dynamic_slice_in_dim(v0, s, chunk)
        ce1 = lax.dynamic_slice_in_dim(e1, s, chunk)
        ce2 = lax.dynamic_slice_in_dim(e2, s, chunk)
        cva = lax.dynamic_slice_in_dim(valid, s, chunk)
        t, u, v, ok = _tri_chunk_hits(
            rays.o, rays.d, cv0, ce1, ce2, cva, culling=culling
        )
        t = jnp.where(ok, t, INF)
        local = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, local[:, None], axis=1)[:, 0]
        umin = jnp.take_along_axis(u, local[:, None], axis=1)[:, 0]
        vmin = jnp.take_along_axis(v, local[:, None], axis=1)[:, 0]
        better = tmin < bt
        return (
            jnp.where(better, tmin, bt),
            jnp.where(better, (s + local).astype(jnp.int32), bi),
            jnp.where(better, umin, bu),
            jnp.where(better, vmin, bv),
        ), None

    if n_chunks == 0:
        return _v0()
    (bt, bi, bu, bv), _ = lax.scan(
        step, _v0(), jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return bt, bi, bu, bv


def _tri_features(v0, e1, e2):
    """Per-triangle feature matrix for the matmul formulation of
    Möller-Trumbore. Each of det / u_num / v_num / t_num is a scalar triple
    product, which is bilinear between per-RAY quantities and per-TRIANGLE
    quantities:

        det   = e1.(d x e2)        = -d . ng                 (ng = e1 x e2)
        u_num = (o - v0).(d x e2)  = (o x d).e2 + d.(v0 x e2)
        v_num = d.((o - v0) x e1)  = -(o x d).e1 + d.(e1 x v0)
        t_num = e2.((o - v0) x e1) = o.ng - v0.ng

    With ray features F = [o x d, d, o, 1] (N, 10), all four values for all
    (ray, triangle) pairs are ONE matmul F @ G with G (10, 4T). Returns G.
    """
    ng = cross(e1, e2)
    zeros = jnp.zeros_like(v0)
    zcol = jnp.zeros_like(v0[:, :1])
    # columns: [coeff of (o x d) (3), coeff of d (3), coeff of o (3), const]
    g_det = jnp.concatenate([zeros, -ng, zeros, zcol], axis=1)
    g_u = jnp.concatenate(
        [e2, cross(v0, e2), zeros, zcol], axis=1
    )
    g_v = jnp.concatenate(
        [-e1, cross(e1, v0), zeros, zcol], axis=1
    )
    g_t = jnp.concatenate(
        [zeros, zeros, ng, -dot(v0, ng)[:, None]], axis=1
    )
    # (T, 4, 10) -> (10, 4T), laid out so a chunk slice stays contiguous
    return jnp.stack([g_det, g_u, g_v, g_t], axis=1).reshape(-1, 10).T


def _ray_features(o, d):
    """(N, 10) ray features [o x d, d, o, 1] for the matmul formulation."""
    return jnp.concatenate(
        [cross(o, d), d, o, jnp.ones_like(o[:, :1])], axis=1
    )


# Triangle chunk per scan step of the matmul formulation.
TRI_CHUNK_MM = 512


def intersect_triangles_mm(rays: Rays, v0, e1, e2, valid, chunk=TRI_CHUNK_MM):
    """Matmul-formulation nearest-hit: identical contract to ``intersect_triangles``
    but the inner sweep is (N, 10) @ (10, 4C) matmuls scanned over triangle
    chunks, with a division-free hit test; (u, v) for the winning triangle
    are recomputed once per ray with the numerically-stable classic form.

    To bound cancellation in the expanded triple products the scene is
    re-centered about the triangle-table centroid (both formulations are
    translation invariant; the expansion is not, so centering keeps the
    products small).
    """
    n = rays.o.shape[0]
    t_total = v0.shape[0]
    chunk = min(chunk, t_total)
    n_chunks = t_total // chunk if t_total else 0
    if n_chunks == 0 or t_total % chunk:
        return intersect_triangles(rays, v0, e1, e2, valid)

    center = jnp.mean(v0, axis=0)
    g = _tri_features(v0 - center, e1, e2)          # (10, 4T)
    g = g.T.reshape(t_total, 4, 10)                  # chunkable on axis 0
    f = _ray_features(rays.o - center, rays.d)       # (N, 10)
    big = jnp.float32(3.4e38)
    valid_f = valid.astype(jnp.float32)

    def step(carry, ci):
        bt, bi = carry
        s = ci * chunk
        gc = lax.dynamic_slice_in_dim(g, s, chunk).reshape(chunk * 4, 10)
        vc = lax.dynamic_slice_in_dim(valid_f, s, chunk)
        # HIGHEST: full f32. A reduced-precision product (bf16 or TF32,
        # relative error ~1e-3) flips hit/miss on a few % of rays.
        prod = jnp.dot(
            f, gc.T, preferred_element_type=jnp.float32, precision=_HI,
        )
        prod = prod.reshape(n, chunk, 4)
        det = prod[..., 0]
        u_num = prod[..., 1]
        v_num = prod[..., 2]
        t_num = prod[..., 3]
        # division-free hit test: with s = sign(det), a = |det|
        sgn = jnp.sign(det)
        absd = jnp.abs(det)
        u_s = u_num * sgn
        v_s = v_num * sgn
        t_s = t_num * sgn
        ok = (
            (absd >= K_EPS)
            & (u_s >= 0.0)
            & (v_s >= 0.0)
            & (u_s + v_s <= absd)
            & (t_s > K_EPS * absd)
            & (vc[None, :] > 0.0)
        )
        t = jnp.where(ok, t_num / jnp.where(det == 0.0, 1.0, det), big)
        local = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, local[:, None], axis=1)[:, 0]
        better = tmin < bt
        return (
            jnp.where(better, tmin, bt),
            jnp.where(better, (s + local).astype(jnp.int32), bi),
        ), None

    (bt, bi), _ = lax.scan(
        step,
        (jnp.full((n,), big), jnp.full((n,), -1, jnp.int32)),
        jnp.arange(n_chunks, dtype=jnp.int32),
    )

    # winner epilogue: stable classic MT for just (N,) pairs
    ix = jnp.maximum(bi, 0)
    w_v0 = v0[ix]
    w_e1 = e1[ix]
    w_e2 = e2[ix]
    pvec = cross(rays.d, w_e2)
    det = dot(w_e1, pvec)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tvec = rays.o - w_v0
    bu = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, w_e1)
    bv = dot(rays.d, qvec) * inv_det
    bt_stable = dot(w_e2, qvec) * inv_det
    hit = bi >= 0
    return (
        jnp.where(hit, bt_stable, INF),
        bi,
        jnp.where(hit, bu, 0.0),
        jnp.where(hit, bv, 0.0),
    )


def intersect_spheres(rays: Rays, center, radius, valid):
    """Nearest sphere hit per ray; numerically-stable q-form quadratic
    (reference: Src/primitive.h:133-177). Returns (t, idx)."""
    o, d = rays.o, rays.d
    ell = o[:, None, :] - center[None, :, :]            # (N, S, 3)
    a = dot(d, d)[:, None]
    b = 2.0 * jnp.einsum("nj,nsj->ns", d, ell, precision=_HI)
    c = (
        jnp.einsum("nsj,nsj->ns", ell, ell, precision=_HI)
        - (radius * radius)[None, :]
    )
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b > 0.0, -0.5 * (b + sq), -0.5 * (b - sq))
    q_safe = jnp.where(q == 0.0, 1.0, q)
    x0 = q / a
    x1 = jnp.where(q == 0.0, x0, c / q_safe)
    t0 = jnp.minimum(x0, x1)
    t1 = jnp.maximum(x0, x1)
    t = jnp.where(t0 > 0.0, t0, t1)
    ok = (disc >= 0.0) & (t > 0.0) & valid[None, :]
    t = jnp.where(ok, t, INF)
    idx = jnp.argmin(t, axis=1).astype(jnp.int32)
    tmin = jnp.take_along_axis(t, idx[:, None], axis=1)[:, 0]
    idx = jnp.where(tmin < INF, idx, -1)
    return tmin, idx


def intersect_boxes(rays: Rays, bmin, bmax, valid):
    """Nearest AABB hit per ray, slab method filling entry t0 and exit t1
    (reference: Src/primitive.h:243-264). Returns (t0, t1, idx)."""
    d = rays.d
    # guard exactly-zero components (axis-aligned rays) against 0*inf NaNs
    d_safe = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    inv = 1.0 / d_safe
    ta = (bmin[None, :, :] - rays.o[:, None, :]) * inv[:, None, :]
    tb = (bmax[None, :, :] - rays.o[:, None, :]) * inv[:, None, :]
    tmin = jnp.minimum(ta, tb)
    tmax = jnp.maximum(ta, tb)
    t0 = jnp.max(tmin, axis=-1)
    t1 = jnp.min(tmax, axis=-1)
    ok = (t0 <= t1) & (t1 > 0.0) & valid[None, :]
    t0 = jnp.maximum(t0, 0.0)
    t0 = jnp.where(ok, t0, INF)
    t1 = jnp.where(ok, t1, INF)
    idx = jnp.argmin(t0, axis=1).astype(jnp.int32)
    e0 = jnp.take_along_axis(t0, idx[:, None], axis=1)[:, 0]
    e1 = jnp.take_along_axis(t1, idx[:, None], axis=1)[:, 0]
    idx = jnp.where(e0 < INF, idx, -1)
    return e0, e1, idx


def _gather3(a, i):
    return a[jnp.maximum(i, 0)]


def _table_nonempty(obj_ids):
    """True when a primitive table has any real (non-sentinel) row. Resolved
    STATICALLY at trace time when the scene is a closed-over constant
    (always the case for the render/bench path) so empty tables compile to
    nothing; conservatively True when the ids are traced."""
    import numpy as np

    try:
        return bool(np.asarray(obj_ids).max() >= 0)
    except Exception:  # traced (e.g. a donated pytree arg): keep the sweep
        return True


def _gather_rec(tri_rec, ti):
    """Winner-record fetch ``tri_rec[ti]``; callers mask miss lanes
    (``ti = -1``).

    Tables of up to 1024 rows use an exact one-hot matmul (one row
    survives, HIGHEST precision), whose transpose under ``jax.grad`` is a
    matmul rather than a scatter-add; larger tables gather."""
    n_rows = tri_rec.shape[0]
    if n_rows > 1024:
        return tri_rec[jnp.maximum(ti, 0)]
    one_hot = (
        ti[:, None] == jnp.arange(n_rows, dtype=ti.dtype)[None, :]
    ).astype(tri_rec.dtype)
    return jnp.dot(one_hot, tri_rec, precision=_HI)


def intersect_scene(scene, rays: Rays) -> Hit:
    """Nearest hit across all primitive tables, with full surface record
    (triangles through ``intersect_triangles_mm``)."""
    n = rays.o.shape[0]
    tt, ti, tu, tv = intersect_triangles_mm(
        rays, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_obj >= 0
    )
    rec = _gather_rec(scene.tri_rec, ti)
    if _table_nonempty(scene.sph_obj):
        st, si = intersect_spheres(
            rays, scene.sph_center, scene.sph_radius, scene.sph_obj >= 0
        )
    else:
        st = jnp.full((n,), INF)
        si = jnp.full((n,), -1, jnp.int32)
    if _table_nonempty(scene.box_obj):
        b0, b1, bi = intersect_boxes(
            rays, scene.box_min, scene.box_max, scene.box_obj >= 0
        )
    else:
        b0 = jnp.full((n,), INF)
        b1 = jnp.full((n,), INF)
        bi = jnp.full((n,), -1, jnp.int32)

    # winner: 0 = triangle, 1 = sphere, 2 = box
    t_all = jnp.stack([tt, st, b0], axis=1)
    kind = jnp.argmin(t_all, axis=1)
    t = jnp.min(t_all, axis=1)
    hit = t < INF

    # triangle surface record (reference: Src/primitive.cpp:96-110) —
    # from the packed (T, 32) record
    te1 = rec[:, 18:21]
    te2 = rec[:, 21:24]
    w = (1.0 - tu - tv)[:, None]
    tri_ng = normalize(cross(te1, te2))
    # deliberate fix vs. the reference: barycentric-interpolated normals are
    # re-normalized (Src/primitive.cpp:107 leaves them non-unit, which skews
    # the ONB for smooth meshes; all reference scenes use flat normals).
    tri_ns_raw = (
        w * rec[:, 0:3]
        + tu[:, None] * rec[:, 3:6]
        + tv[:, None] * rec[:, 6:9]
    )
    tri_ns = normalize(tri_ns_raw, eps=1e-20)
    tri_uv = (
        w * rec[:, 9:11]
        + tu[:, None] * rec[:, 11:13]
        + tv[:, None] * rec[:, 13:15]
    )
    tri_obj = jnp.where(ti >= 0, rec[:, 24].astype(jnp.int32), -1)
    tri_light = rec[:, 25].astype(jnp.int32)
    tri_medium = rec[:, 26].astype(jnp.int32)
    tri_mtype = rec[:, 27].astype(jnp.int32)
    tri_ior = rec[:, 28]
    tri_albedo = rec[:, 29:32]

    # sphere surface record (reference: Src/primitive.h:113-123)
    six = jnp.maximum(si, 0)
    sc = scene.sph_center[six]
    sphere_pos = rays.at(st)
    sph_ng = normalize(sphere_pos - sc)
    sph_uv = jnp.stack(
        [
            (1.0 + jnp.arctan2(sph_ng[:, 2], sph_ng[:, 0]) / jnp.pi) * 0.5,
            jnp.arccos(jnp.clip(sph_ng[:, 1], -1.0, 1.0)) / jnp.pi,
        ],
        axis=-1,
    )
    sph_obj = jnp.where(si >= 0, scene.sph_obj[six], -1)
    sph_oix = jnp.maximum(sph_obj, 0)
    sph_light = jnp.where(sph_obj >= 0, scene.obj_light[sph_oix], -1)
    sph_medium = jnp.where(sph_obj >= 0, scene.obj_medium[sph_oix], -1)
    sph_mat = scene.obj_mat[sph_oix]
    sph_mix = jnp.maximum(sph_mat, 0)
    sph_mtype = jnp.where(
        (sph_obj >= 0) & (sph_mat >= 0), scene.mat_type[sph_mix], -1
    )
    sph_ior = scene.mat_ior[sph_mix]
    sph_albedo = scene.mat_albedo[sph_mix]

    # box record: t/t1 only, no surface (reference: Src/primitive.h:256-259)
    bix = jnp.maximum(bi, 0)
    box_obj = jnp.where(bi >= 0, scene.box_obj[bix], -1)
    box_oix = jnp.maximum(box_obj, 0)
    box_light = jnp.where(box_obj >= 0, scene.obj_light[box_oix], -1)
    box_medium = jnp.where(box_obj >= 0, scene.obj_medium[box_oix], -1)

    is_tri = (kind == 0) & hit
    is_sph = (kind == 1) & hit
    is_box = (kind == 2) & hit

    obj = jnp.where(
        is_tri, tri_obj, jnp.where(is_sph, sph_obj, jnp.where(is_box, box_obj, -1))
    )
    light = jnp.where(
        is_tri, tri_light,
        jnp.where(is_sph, sph_light, jnp.where(is_box, box_light, -1)),
    )
    medium = jnp.where(
        is_tri, tri_medium,
        jnp.where(is_sph, sph_medium, jnp.where(is_box, box_medium, -1)),
    )
    mtype = jnp.where(is_tri, tri_mtype, jnp.where(is_sph, sph_mtype, -1))
    ior = jnp.where(is_tri, tri_ior, jnp.where(is_sph, sph_ior, 1.0))
    albedo = jnp.where(
        is_tri[:, None], tri_albedo, jnp.where(is_sph[:, None], sph_albedo, 0.0)
    )
    t = jnp.where(obj >= 0, t, INF)
    t1 = jnp.where(is_box, b1, INF)

    position = rays.at(jnp.where(obj >= 0, t, 0.0))
    ng = jnp.where(is_tri[:, None], tri_ng, jnp.where(is_sph[:, None], sph_ng, 0.0))
    ns = jnp.where(is_tri[:, None], tri_ns, jnp.where(is_sph[:, None], sph_ng, 0.0))
    uv = jnp.where(is_tri[:, None], tri_uv, jnp.where(is_sph[:, None], sph_uv, 0.0))
    # frame from the shading normal (reference: Src/primitive.cpp:107-108);
    # guard the miss/box lanes so ONB math stays finite.
    ns_safe = jnp.where((is_tri | is_sph)[:, None], ns, jnp.array([0.0, 1.0, 0.0]))
    dpdu, dpdv = orthonormal_basis(ns_safe)
    surf = (is_tri | is_sph)[:, None]
    dpdu = jnp.where(surf, dpdu, 0.0)
    dpdv = jnp.where(surf, dpdv, 0.0)

    return Hit(
        t=t,
        t1=t1,
        obj=obj,
        position=position,
        ng=ng,
        ns=ns,
        dpdu=dpdu,
        dpdv=dpdv,
        uv=uv,
        bary=jnp.stack([tu, tv], axis=-1) * is_tri[:, None],
        light=light,
        medium=medium,
        mtype=mtype,
        ior=ior,
        albedo=albedo,
    )


def occluded(scene, rays: Rays, t_max):
    """Shadow-ray test: any blocking hit with t < t_max.

    Mirrors Src/scene.cpp:202-211: objects carrying an area light never
    block. Medium boxes never block (deliberate fix, see module docstring).
    Returns (N,) bool.
    """
    tri_light = scene.obj_light[jnp.maximum(scene.tri_obj, 0)]
    tri_blocks = (scene.tri_obj >= 0) & (tri_light < 0)
    tt, _, _, _ = intersect_triangles_mm(
        rays, scene.tri_v0, scene.tri_e1, scene.tri_e2, tri_blocks
    )
    blocked = tt < t_max

    if _table_nonempty(scene.sph_obj):
        sph_light = scene.obj_light[jnp.maximum(scene.sph_obj, 0)]
        sph_blocks = (scene.sph_obj >= 0) & (sph_light < 0)
        st, _ = intersect_spheres(
            rays, scene.sph_center, scene.sph_radius, sph_blocks
        )
        blocked = blocked | (st < t_max)

    return blocked
