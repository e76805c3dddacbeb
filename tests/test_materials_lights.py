"""Analytic tests for BSDFs and lights (SURVEY.md §4: furnace test, pdf
conventions, one-sided emission)."""

import jax.numpy as jnp
import numpy as np
import pytest

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import make_furnace_integrator
from xraytracer.lights import (
    area_light_le,
    sample_area_light,
    sample_delta_light,
)
from xraytracer.materials import eval_bsdf, sample_bsdf
from xraytracer.math import dot, from_rows, normalize
from xraytracer.renderer import render
from xraytracer.sampling import path_keys, uniform2, uniform1
from xraytracer.scene.builder import SceneBuilder


def _lambert_scene(albedo=(0.7, 0.5, 0.3)):
    b = SceneBuilder()
    quad = np.asarray(
        [
            [[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
            [[10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    b.add_mesh(quad, material=b.add_lambert(albedo))
    return b.build()


@pytest.mark.parametrize("cosine", [False, True])
def test_furnace(cosine):
    """E[fr*cos/pdf] == albedo for both Lambert sampling strategies — the
    reference's latent furnace check (Src/integrator.h:59-66) made live."""
    albedo = (0.7, 0.5, 0.3)
    tables = _lambert_scene(albedo)
    # camera at (0, 5, 0) looking straight down at the plane
    c2w = from_rows(1.0, 0, 0, 0, 0, 0, 1, 0, 0, 1.0, 0, 0, 0, 5.0, 0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=30.0)
    integ = make_furnace_integrator(tables, cosine_sampling=cosine)
    r = render(tables, cam, integ, 16, 16, 512)
    est = r.image.reshape(-1, 3).mean(axis=0)
    np.testing.assert_allclose(est, albedo, rtol=0.05)


def test_eval_bsdf_is_albedo_over_pi():
    tables = _lambert_scene((0.6, 0.6, 0.6))
    obj = jnp.zeros((4,), jnp.int32)
    wo = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (4, 1))
    wi = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (4, 1))
    f = eval_bsdf(tables, obj, wo, wi)
    np.testing.assert_allclose(np.asarray(f), 0.6 / np.pi, rtol=1e-5)


def test_mirror_reflects():
    b = SceneBuilder()
    quad = np.asarray([[[-1, 0, -1], [1, 0, -1], [-1, 0, 1]]], np.float32)
    b.add_mesh(quad, material=b.add_mirror((1.0, 1.0, 1.0)))
    tables = b.build()
    obj = jnp.zeros((1,), jnp.int32)
    wo = normalize(jnp.asarray([[0.5, 0.8, 0.1]]))
    keys = path_keys(0, jnp.arange(1, dtype=jnp.int32), 0)
    bs = sample_bsdf(tables, obj, wo, uniform2(keys, 0), uniform1(keys, 1))
    # perfect mirror about +Y: (x, y, z) -> (-x, y, -z)
    expect = jnp.stack([-wo[:, 0], wo[:, 1], -wo[:, 2]], axis=-1)
    np.testing.assert_allclose(np.asarray(bs.wi), np.asarray(expect), atol=1e-6)
    assert bool(bs.is_delta[0])
    np.testing.assert_allclose(np.asarray(bs.weight), 1.0, atol=1e-6)


def test_glass_energy_split():
    """Monte-Carlo over the lobe choice: reflect fraction ~ Fresnel kr."""
    b = SceneBuilder()
    quad = np.asarray([[[-1, 0, -1], [1, 0, -1], [-1, 0, 1]]], np.float32)
    b.add_mesh(quad, material=b.add_glass(ior=1.3, tint=(1, 1, 1)))
    tables = b.build()
    n = 4096
    obj = jnp.zeros((n,), jnp.int32)
    wo = jnp.tile(normalize(jnp.asarray([[0.3, 0.9, 0.0]])), (n, 1))
    keys = path_keys(0, jnp.arange(n, dtype=jnp.int32), 0)
    bs = sample_bsdf(tables, obj, wo, uniform2(keys, 0), uniform1(keys, 1))
    frac_reflect = float(jnp.mean((bs.wi[:, 1] > 0).astype(jnp.float32)))
    # Fresnel at ~18 deg from normal, ior 1.3: kr ~ 0.017..0.03
    assert 0.005 < frac_reflect < 0.08
    # transmission lanes are flagged for re-origin on the far side
    assert bool(jnp.all(bs.flip_side == (bs.wi[:, 1] < 0)))


def test_quad_light_pdf_solid_angle():
    """MC integral of 1/pdf over the quad's samples equals its solid angle
    (validates the t^3/|d.Ng| convention, Src/light.cpp:59-68)."""
    b = SceneBuilder()
    # unit quad at height 2, facing down (Ng = e1 x e2 = -y, toward origin)
    b.add_quad_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (-0.5, 2.0, 0.5), (1, 1, 1))
    tables = b.build()
    n = 8192
    lidx = jnp.zeros((n,), jnp.int32)
    pos = jnp.zeros((n, 3))
    keys = path_keys(0, jnp.arange(n, dtype=jnp.int32), 0)
    ls = sample_area_light(tables, lidx, pos, uniform2(keys, 0))
    assert bool(jnp.all(ls.pdf > 0))
    assert bool(jnp.all(ls.le[:, 0] == 1.0))  # frontfacing from below
    # E[1/pdf] under uniform-area sampling = solid angle of the quad:
    # exact 4*arctan(ab / (2d sqrt(4d^2+a^2+b^2))) = 0.23549 for a=b=1, d=2
    omega = float(jnp.mean(1.0 / ls.pdf))
    assert abs(omega - 0.23549) < 0.01


def test_sphere_light_cone_pdf():
    """Cone pdf = 1/(2 pi (1 - cos_theta_max)) and E[1/pdf] = cone solid
    angle (Src/light.h:160-198)."""
    b = SceneBuilder()
    b.add_sphere_light((0.0, 4.0, 0.0), 1.0, (5, 5, 5))
    tables = b.build()
    n = 4096
    lidx = jnp.zeros((n,), jnp.int32)
    pos = jnp.zeros((n, 3))
    keys = path_keys(1, jnp.arange(n, dtype=jnp.int32), 0)
    ls = sample_area_light(tables, lidx, pos, uniform2(keys, 0))
    # r=1 at distance 4: sin_theta_max = 1/4
    expect_pdf = 1.0 / (2 * np.pi * (1 - np.sqrt(1 - 1 / 16)))
    np.testing.assert_allclose(np.asarray(ls.pdf), expect_pdf, rtol=1e-4)
    # all sampled directions point at the sphere and hit its front side
    assert bool(jnp.all(ls.le[:, 0] == 5.0))
    assert bool(jnp.all(ls.wi[:, 1] > 0.8))


def test_one_sided_emission():
    """Le returns 0 for backfaces (Src/light.h:62-69)."""
    b = SceneBuilder()
    b.add_quad_light((0.5, 2.0, -0.5), (-0.5, 2.0, -0.5), (0.5, 2.0, 0.5), (3, 3, 3))
    tables = b.build()
    lidx = jnp.zeros((2,), jnp.int32)
    ns = jnp.asarray([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    # seen from below (wo = up toward light's front): ... quad faces down
    wo = jnp.asarray([[0.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    le = area_light_le(tables, lidx, wo, ns)
    assert np.asarray(le)[0, 0] == 3.0  # front
    assert np.asarray(le)[1, 0] == 0.0  # back


def test_point_light_inverse_square():
    """pdf = distance^2 folds the inverse-square law in
    (Src/light.cpp:115-128)."""
    b = SceneBuilder()
    b.add_point_light((0.0, 3.0, 0.0), (1.0, 1.0, 1.0), 50.0)
    tables = b.build()
    pos = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    lidx = jnp.zeros((2,), jnp.int32)
    ls = sample_delta_light(tables, lidx, pos)
    np.testing.assert_allclose(np.asarray(ls.pdf), [9.0, 1.0], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ls.le), 50.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ls.wi[:, 1]), 1.0, atol=1e-6)


def test_distant_light():
    b = SceneBuilder()
    b.add_distant_light((0.0, -1.0, 0.0), (1.0, 1.0, 1.0), 2.0)
    tables = b.build()
    pos = jnp.zeros((1, 3))
    ls = sample_delta_light(tables, jnp.zeros((1,), jnp.int32), pos)
    np.testing.assert_allclose(np.asarray(ls.wi), [[0.0, 1.0, 0.0]], atol=1e-6)
    assert np.asarray(ls.pdf)[0] == 1.0
    assert not np.isfinite(np.asarray(ls.t_max)[0]) or np.asarray(ls.t_max)[0] > 1e30


def test_sphere_light_area_strategy():
    """AREA_SAMPLING-style surface sampling integrates to the same
    irradiance as cone sampling (corrected pdf, see lights.py)."""
    b = SceneBuilder()
    b.add_sphere_light((0.0, 4.0, 0.0), 1.0, (5, 5, 5))
    tables = b.build()
    n = 40000
    lidx = jnp.zeros((n,), jnp.int32)
    pos = jnp.zeros((n, 3))
    keys = path_keys(3, jnp.arange(n, dtype=jnp.int32), 0)
    # E[Le * cos_surface / pdf] estimates the same quantity per strategy
    est = {}
    for strat in ("cone", "area", "intersect"):
        ls = sample_area_light(tables, lidx, pos, uniform2(keys, 0),
                               sphere_strategy=strat)
        ok = np.asarray(ls.pdf) > 0
        contrib = np.asarray(ls.le)[:, 0] * np.maximum(
            np.asarray(ls.wi)[:, 1], 0.0
        ) / np.where(ok, np.asarray(ls.pdf), 1.0)
        est[strat] = (contrib * ok).mean()
    np.testing.assert_allclose(est["area"], est["cone"], rtol=0.05)
    # INTERSECT_METHOD (Src/light.h:136-156) shares the cone pdf and must
    # estimate the same irradiance
    np.testing.assert_allclose(est["intersect"], est["cone"], rtol=0.05)


def test_sphere_light_intersect_strategy_details():
    """The intersect strategy's samples lie ON the sphere surface, are
    front-facing, and interior shading points get Le = 0
    (Src/light.h:150-156)."""
    b = SceneBuilder()
    b.add_sphere_light((0.0, 4.0, 0.0), 1.0, (5, 5, 5))
    tables = b.build()
    n = 4096
    lidx = jnp.zeros((n,), jnp.int32)
    keys = path_keys(7, jnp.arange(n, dtype=jnp.int32), 0)
    ls = sample_area_light(tables, lidx, jnp.zeros((n, 3)),
                           uniform2(keys, 0), sphere_strategy="intersect")
    p = np.zeros((n, 3)) + np.asarray(ls.wi) * np.asarray(ls.t_max)[:, None]
    r = np.linalg.norm(p - np.asarray([0.0, 4.0, 0.0]), axis=-1)
    lit = np.asarray(ls.le)[:, 0] > 0
    assert lit.mean() > 0.95          # cone aimed at the sphere: mostly hits
    np.testing.assert_allclose(r[lit], 1.0, atol=5e-3)
    expect_pdf = 1.0 / (2 * np.pi * (1 - np.sqrt(1 - 1 / 16)))
    np.testing.assert_allclose(np.asarray(ls.pdf), expect_pdf, rtol=1e-4)
    # shading point INSIDE the sphere -> zero radiance
    inside = sample_area_light(
        tables, jnp.zeros((4,), jnp.int32),
        jnp.tile(jnp.asarray([[0.0, 3.5, 0.0]]), (4, 1)),
        uniform2(path_keys(8, jnp.arange(4, dtype=jnp.int32), 0), 0),
        sphere_strategy="intersect",
    )
    np.testing.assert_array_equal(np.asarray(inside.le), 0.0)


def test_culling_toggle():
    """CULLING define equivalent: backfaces miss when enabled
    (Src/cmakelists.txt:60, Src/primitive.cpp:147-153)."""
    import jax as _jax
    from xraytracer.geometry import Rays as _Rays
    from xraytracer.geometry import intersect as _xi

    b = SceneBuilder()
    # front face (ng = +z) seen from +z, and the same triangle flipped
    b.add_mesh(np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32),
               material=b.add_lambert((1, 1, 1)))
    s = b.build()
    o = jnp.asarray([[0.2, 0.2, 1.0], [0.2, 0.2, -1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    rays = _Rays(o=o, d=d)
    valid = s.tri_obj >= 0
    t_on, *_ = _jax.jit(
        lambda r: _xi.intersect_triangles(
            r, s.tri_v0, s.tri_e1, s.tri_e2, valid, culling=True
        )
    )(rays)
    t_off, *_ = _jax.jit(
        lambda r: _xi.intersect_triangles(
            r, s.tri_v0, s.tri_e1, s.tri_e2, valid, culling=False
        )
    )(rays)
    t_on, t_off = np.asarray(t_on), np.asarray(t_off)
    assert t_off[0] < 1e30 and t_off[1] < 1e30  # both sides hit w/o culling
    # with culling exactly one side (det > 0) hits
    assert (t_on < 1e30).sum() == 1


def test_light_power_weights():
    """Host-side power weights: mean(Le) * area * pi with the per-type
    area forms (tri |Ng|/2, quad |Ng|, sphere 4 pi r^2); padding rows 0."""
    from xraytracer.lights import light_power_weights

    b = SceneBuilder()
    b.add_triangle_light((0, 0, 0), (2, 0, 0), (0, 2, 0), (1, 1, 1))
    b.add_quad_light((0, 5, 0), (1, 5, 0), (0, 5, 2), (3, 0, 0))
    b.add_sphere_light((0, 9, 0), 0.5, (2, 2, 2))
    w = light_power_weights(b.build())
    np.testing.assert_allclose(
        w[:3],
        [2.0 * np.pi, 2.0 * np.pi, 2.0 * np.pi ** 2],
        rtol=1e-6,
    )
    assert (w[3:] == 0.0).all()


def _two_light_scene(le_a=(9.0, 9.0, 9.0), le_b=(1.0, 1.0, 1.0)):
    b = SceneBuilder()
    # wound so the geometric normal points UP (+y) toward the lights
    floor = np.asarray(
        [[[-4, -1, -4], [4, -1, 4], [4, -1, -4]],
         [[-4, -1, -4], [-4, -1, 4], [4, -1, 4]]], np.float32,
    )
    b.add_mesh(floor, material=b.add_lambert((0.8, 0.8, 0.8)))
    b.add_quad_light((-2.0, 2.0, -0.5), (-1.0, 2.0, -0.5), (-2.0, 2.0, 0.5),
                     le_a)
    b.add_quad_light((1.0, 2.0, -0.5), (2.0, 2.0, -0.5), (1.0, 2.0, 0.5),
                     le_b)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.6, 4.0, 1)
    return b.build(), dict(c2w=c2w, fov_deg=60.0)


def test_power_nee_unbiased_and_lower_variance():
    """nee_mode="power" (power-proportional single-light NEE through the
    general DiscreteDistribution1D) keeps the expectation of "all" and has
    LOWER seed-to-seed variance than uniform "one" when light powers are
    skewed (here 9:1)."""
    from xraytracer.integrators import make_path_integrator
    from xraytracer.scene.builder import scene_statics

    tables, camk = _two_light_scene()
    statics = scene_statics(tables)
    W, H = 48, 36
    cam = PinholeCamera.make(W / H, **camk)

    def render_mode(mode, seed, spp):
        integ = make_path_integrator(
            tables, statics, max_depth=1, nee=True, cosine_sampling=True,
            nee_mode=mode,
        )
        return np.asarray(render(tables, cam, integ, W, H, spp,
                                 seed=seed).image)

    ref = render_mode("all", 0, 96)
    pw = render_mode("power", 0, 96)
    # same expectation: image means agree within Monte-Carlo noise
    np.testing.assert_allclose(pw.mean(), ref.mean(), rtol=0.04)

    # variance: per-pixel spread across seeds, power < uniform one
    seeds = range(1, 6)
    var_one = np.var([render_mode("one", s, 16) for s in seeds], axis=0)
    var_pow = np.var([render_mode("power", s, 16) for s in seeds], axis=0)
    assert var_pow.mean() < var_one.mean()
