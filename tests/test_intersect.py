import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xraytracer.geometry import Rays
from xraytracer.geometry import intersect as xi
from xraytracer.scene import SceneBuilder

# eager dispatch is pathologically slow in this environment — always jit
intersect_scene = jax.jit(xi.intersect_scene)
occluded = jax.jit(xi.occluded)


def make_rays(o, d):
    o = np.atleast_2d(np.asarray(o, np.float32))
    d = np.asarray(d, np.float32)
    d = np.atleast_2d(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return Rays(o=jnp.asarray(o), d=jnp.asarray(d))


def test_single_triangle_hit_miss():
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    b.add_mesh(
        np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32), material=m
    )
    s = b.build()
    rays = make_rays(
        [[0.2, 0.2, 1.0], [0.9, 0.9, 1.0]], [[0, 0, -1], [0, 0, -1]]
    )
    h = intersect_scene(s, rays)
    assert bool(h.hit[0]) and not bool(h.hit[1])
    np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.position[0]), [0.2, 0.2, 0.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.ng[0]), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.bary[0]), [0.2, 0.2], atol=1e-5)
    # uv = barycentric corner interp (builder default corners)
    np.testing.assert_allclose(np.asarray(h.uv[0]), [0.2, 0.2], atol=1e-5)


def test_nearest_of_two_triangles():
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    tri = np.asarray([[[-1, -1, 0], [3, -1, 0], [-1, 3, 0]]], np.float32)
    b.add_mesh(tri, material=m)              # z=0
    b.add_mesh(tri + [0, 0, 0.5], material=m)  # z=0.5, closer to camera at z=1
    s = b.build()
    h = intersect_scene(s, make_rays([0, 0, 1.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 0.5, rtol=1e-5)
    assert int(h.obj[0]) == 1


def test_sphere_hit_inside_outside():
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    b.add_sphere((0, 0, 0), 1.0, material=m)
    s = b.build()
    h = intersect_scene(s, make_rays([0, 0, 3.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.ng[0]), [0, 0, 1], atol=1e-5)
    # from inside: hits the far shell (t0 < 0 -> t1), normal points outward
    h = intersect_scene(s, make_rays([0, 0, 0.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.ng[0]), [0, 0, -1], atol=1e-5)
    # sphere uv (reference: Src/primitive.h:118-120)
    h = intersect_scene(s, make_rays([3, 0, 0.0], [-1, 0, 0]))
    # ng=(1,0,0): u = (1 + atan2(0,1)/pi)/2 = 0.5, v = acos(0)/pi = 0.5
    # (reference: Src/primitive.h:118-120)
    np.testing.assert_allclose(np.asarray(h.uv[0]), [0.5, 0.5], atol=1e-5)


def test_box_entry_exit_and_inside():
    b = SceneBuilder()
    b.add_homogeneous_medium(0.0, 0.5, 0.5, (-1, -1, -1), (1, 1, 1))
    s = b.build()
    h = intersect_scene(s, make_rays([0, 0, 5.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
    np.testing.assert_allclose(float(h.t1[0]), 6.0, rtol=1e-5)
    # origin inside: entry clamps to 0 (reference: Src/primitive.h:258)
    h = intersect_scene(s, make_rays([0, 0, 0.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(h.t1[0]), 1.0, rtol=1e-5)
    # behind: miss
    h = intersect_scene(s, make_rays([0, 0, -5.0], [0, 0, -1]))
    assert not bool(h.hit[0])
    # axis-parallel ray with zero components outside slab: miss, no NaN
    h = intersect_scene(s, make_rays([3.0, 0, 5.0], [0, 0, -1]))
    assert not bool(h.hit[0])


def test_nearest_across_kinds():
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    b.add_sphere((0, 0, 0), 1.0, material=m)
    b.add_mesh(
        np.asarray([[[-2, -2, 2], [2, -2, 2], [0, 2, 2]]], np.float32),
        material=m,
    )
    b.add_homogeneous_medium(0.0, 0.5, 0.5, (-4, -4, -4), (4, 4, 4))
    s = b.build()
    # camera at z=6 looking -z: box at t=2, triangle at t=4, sphere at t=5
    h = intersect_scene(s, make_rays([0, 0, 6.0], [0, 0, -1]))
    np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
    assert int(h.obj[0]) == 2  # box object (third object added)


def test_normals_interpolation():
    # smooth-shaded triangle: ns interpolates vertex normals, ng is geometric
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    n0 = np.array([0, 0, 1], np.float32)
    n1 = np.array([1, 0, 0], np.float32)
    n2 = np.array([0, 1, 0], np.float32)
    b.add_mesh(
        np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32),
        np.asarray([[n0, n1, n2]]),
        material=m,
    )
    s = b.build()
    h = intersect_scene(s, make_rays([0.25, 0.25, 1.0], [0, 0, -1]))
    expect = 0.5 * n0 + 0.25 * n1 + 0.25 * n2
    expect = expect / np.linalg.norm(expect)
    np.testing.assert_allclose(np.asarray(h.ns[0]), expect, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.ng[0]), [0, 0, 1], atol=1e-6)
    # frame is orthonormal around ns
    assert abs(float(jnp.sum(h.dpdu[0] * h.dpdv[0]))) < 1e-5


def test_occluded_skips_emitters_and_media():
    b = SceneBuilder()
    m = b.add_lambert((1, 1, 1))
    # blocking wall at z=2
    wall = np.asarray([[[-5, -5, 2], [5, -5, 2], [0, 5, 2]]], np.float32)
    b.add_mesh(wall, material=m)
    # emissive quad at z=3 must NOT block (reference: Src/scene.cpp:206)
    b.add_quad_light((-1, -1, 3), (1, -1, 3), (-1, 1, 3), (5, 5, 5))
    # medium box at z in [4,5] must NOT block (deliberate fix)
    b.add_homogeneous_medium(0.0, 0.5, 0.5, (-5, -5, 4), (5, 5, 5))
    s = b.build()
    o = jnp.asarray([[0.0, 0.0, 0.0]] * 3)
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    rays = Rays(o=o, d=d)
    t_max = jnp.asarray([10.0, 1.5, 10.0])
    occ = np.asarray(occluded(s, rays, t_max))
    assert occ[0]          # wall blocks at t=2 < 10
    assert not occ[1]      # t_max=1.5 shorter than wall distance
    # remove the wall: only emitter+medium remain -> never occluded
    b2 = SceneBuilder()
    b2.add_quad_light((-1, -1, 3), (1, -1, 3), (-1, 1, 3), (5, 5, 5))
    b2.add_homogeneous_medium(0.0, 0.5, 0.5, (-5, -5, 4), (5, 5, 5))
    s2 = b2.build()
    occ2 = np.asarray(occluded(s2, rays, t_max))
    assert not occ2.any()


def test_empty_scene_misses():
    s = SceneBuilder().build()
    h = intersect_scene(s, make_rays([0, 0, 0], [0, 0, -1]))
    assert not bool(h.hit[0])
    assert float(h.t[0]) > 1e30

def test_mm_formulation_matches_reference_path():
    """The MXU (matmul) Möller-Trumbore agrees with the chunked classic
    form on random scenes: same winner, same t/u/v within f32 tolerance."""
    rng = np.random.default_rng(0)
    tris = rng.uniform(-5, 5, (256, 3, 3)).astype(np.float32)
    b = SceneBuilder()
    b.add_mesh(tris, material=b.add_lambert((1, 1, 1)))
    s = b.build()
    n = 512
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(o=jnp.asarray(o), d=jnp.asarray(d))
    valid = s.tri_obj >= 0

    ref = jax.jit(xi.intersect_triangles)(
        rays, s.tri_v0, s.tri_e1, s.tri_e2, valid
    )
    mm = jax.jit(xi.intersect_triangles_mm)(
        rays, s.tri_v0, s.tri_e1, s.tri_e2, valid
    )
    rt, ri, ru, rv = (np.asarray(x) for x in ref)
    mt, mi, mu, mv = (np.asarray(x) for x in mm)
    hit_ref = ri >= 0
    # same hit/miss classification (allow f32 ties at grazing angles/edges:
    # the expanded products round differently from the classic form)
    agree = hit_ref == (mi >= 0)
    assert agree.mean() > 0.985
    both = hit_ref & (mi >= 0) & agree
    # where the same triangle wins, t/u/v match tightly
    same = both & (ri == mi)
    assert same.sum() > 0.9 * both.sum()
    np.testing.assert_allclose(mt[same], rt[same], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(mu[same], ru[same], atol=2e-3)
    np.testing.assert_allclose(mv[same], rv[same], atol=2e-3)
    # a different winner is legitimate only when the two intersections are a
    # near-tie — the hit distance must still agree
    diff = both & (ri != mi)
    if diff.any():
        np.testing.assert_allclose(mt[diff], rt[diff], rtol=5e-3)


def test_mm_formulation_cornell_scale():
    """Large-coordinate scene (Cornell ~550 units): centering keeps the
    expanded triple products accurate."""
    from xraytracer.scene.presets import build_cornell_box

    s = build_cornell_box().build()
    rng = np.random.default_rng(1)
    n = 256
    o = np.tile(np.asarray([[278.0, 274.4, -750.0]], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])  # toward the box
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(o=jnp.asarray(o), d=jnp.asarray(d))
    valid = s.tri_obj >= 0
    ref = jax.jit(xi.intersect_triangles)(
        rays, s.tri_v0, s.tri_e1, s.tri_e2, valid
    )
    mm = jax.jit(xi.intersect_triangles_mm)(
        rays, s.tri_v0, s.tri_e1, s.tri_e2, valid
    )
    rt, ri, _, _ = (np.asarray(x) for x in ref)
    mt, mi, _, _ = (np.asarray(x) for x in mm)
    same = ri == mi
    assert same.mean() > 0.99
    hit = same & (ri >= 0)
    np.testing.assert_allclose(mt[hit], rt[hit], rtol=5e-4)


def _random_mesh_scene(t_total, seed):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_mesh(rng.uniform(-5, 5, (t_total, 3, 3)).astype(np.float32),
               material=b.add_lambert((1, 1, 1)))
    return b.build()


def _random_rays(n, seed):
    rng = np.random.default_rng(seed + 100)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Rays(o=jnp.asarray(o), d=jnp.asarray(d))


@pytest.mark.parametrize("t_total", [32, 64, 96, 128, 256, 600, 1024])
def test_mm_sweep_matches_classic_by_table_size(t_total):
    """The default sweep agrees with the semantics-defining classic sweep
    across table sizes: single chunks, several 512-row chunks, and tables
    that are not a multiple of the mm chunk."""
    s = _random_mesh_scene(t_total, seed=t_total)
    rays = _random_rays(384, seed=t_total)
    args = (rays, s.tri_v0, s.tri_e1, s.tri_e2, s.tri_obj >= 0)
    rt, ri, _, _ = (np.asarray(x) for x in
                    jax.jit(xi.intersect_triangles)(*args))
    mt, mi, _, _ = (np.asarray(x) for x in
                    jax.jit(xi.intersect_triangles_mm)(*args))
    assert (ri >= 0).any()
    assert (ri == mi).mean() > 0.98
    same = (ri == mi) & (ri >= 0)
    np.testing.assert_allclose(mt[same], rt[same], rtol=2e-4, atol=2e-4)
    # a different winner is legitimate only at a near-tie in t
    diff = (ri != mi) & (ri >= 0) & (mi >= 0)
    if diff.any():
        np.testing.assert_allclose(mt[diff], rt[diff], rtol=5e-3)


@pytest.mark.parametrize("t_max_scale", [0.25, 1.0, 4.0])
def test_anyhit_matches_nearest_hit_below_t_max(t_max_scale):
    """``occluded`` (any blocking hit closer than t_max) equals the
    nearest-hit sweep's ``t < t_max`` on a triangle-only scene."""
    s = _random_mesh_scene(256, seed=7)
    rays = _random_rays(512, seed=7)
    t_max = jnp.full((512,), 5.0 * t_max_scale)
    occ = np.asarray(occluded(s, rays, t_max))
    t, _, _, _ = jax.jit(xi.intersect_triangles)(
        rays, s.tri_v0, s.tri_e1, s.tri_e2, s.tri_obj >= 0)
    expect = np.asarray(t) < np.asarray(t_max)
    assert expect.any() and not expect.all()
    assert (occ == expect).mean() > 0.995


@pytest.mark.parametrize("n_rows", [8, 1024, 1025])
@pytest.mark.parametrize("what", ["value", "grad"])
def test_gather_rec_matches_plain_gather(n_rows, what):
    """The winner-record fetch (one-hot matmul up to 1024 rows, gather
    above) equals a plain row gather on hit lanes, and so does its
    gradient. (Miss lanes, ti = -1, are masked by every caller.)"""
    rng = np.random.default_rng(n_rows)
    rec = jnp.asarray(rng.normal(size=(n_rows, 32)).astype(np.float32))
    ti = jnp.asarray(rng.integers(0, n_rows, 257).astype(np.int32))
    w = jnp.asarray(rng.normal(size=(257, 32)).astype(np.float32))

    def plain(r):
        return r[ti]

    if what == "value":
        got = jax.jit(xi._gather_rec)(rec, ti)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(plain(rec)))
    else:
        g_got = jax.jit(jax.grad(
            lambda r: jnp.sum(xi._gather_rec(r, ti) * w)))(rec)
        g_ref = jax.jit(jax.grad(lambda r: jnp.sum(plain(r) * w)))(rec)
        np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_ref),
                                   rtol=1e-6, atol=1e-6)
