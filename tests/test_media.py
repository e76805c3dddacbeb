"""Media tests: closed-form transmittance, escape statistics, tracking
bounds (SURVEY.md §4: known closed-form transmittance checks)."""

import jax.numpy as jnp
import numpy as np
import pytest

from xraytracer.geometry import Rays
from xraytracer.media import (
    density_lookup,
    eval_phase,
    sample_medium,
    segment_transmittance,
)
from xraytracer.sampling import path_keys, hg_phase
from xraytracer.scene.builder import SceneBuilder

N = 4096


def _homog_tables(sigma_a, sigma_s, variant="achromatic"):
    b = SceneBuilder()
    b.add_homogeneous_medium(
        0.0, sigma_a, sigma_s, (-1, -1, -1), (1, 1, 1), variant=variant
    )
    return b.build()


def _rays_through_box(n=N):
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    return Rays(o=o, d=d)


def _keys(n=N, seed=0):
    return path_keys(seed, jnp.arange(n, dtype=jnp.int32), 0)


def test_achromatic_escape_probability():
    """P(escape) = exp(-sigma_t * thickness); escape weight = 1
    (Src/medium.h:195-231)."""
    tables = _homog_tables(0.3, 0.2, "achromatic")
    rays = _rays_through_box()
    t0 = jnp.full((N,), 2.0)   # box entry at z=1
    t1 = jnp.full((N,), 4.0)   # exit at z=-1 (thickness 2)
    ms = sample_medium(
        tables, jnp.zeros((N,), jnp.int32), rays, t0, t1,
        jnp.ones((N, 3)), _keys(), 0, has_heterogeneous=False,
    )
    p_escape = float(jnp.mean((~ms.scattered).astype(jnp.float32)))
    assert abs(p_escape - np.exp(-0.5 * 2.0)) < 0.03
    esc_w = np.asarray(ms.weight)[~np.asarray(ms.scattered)]
    np.testing.assert_allclose(esc_w, 1.0, atol=1e-5)
    # scattered weight = single-scatter albedo
    sc_w = np.asarray(ms.weight)[np.asarray(ms.scattered)]
    np.testing.assert_allclose(sc_w, 0.2 / 0.5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["mis", "nomis"])
def test_spectral_unbiased_transmittance(variant):
    """E[weight * indicator(escape)] = exp(-sigma_t d) per channel even with
    chromatic sigma (the spectral-MIS estimators, Src/medium.h:148-192,
    234-277)."""
    sigma_a = np.asarray([0.2, 0.5, 0.9], np.float32)
    tables = _homog_tables(sigma_a, (0.0, 0.0, 0.0), variant)
    rays = _rays_through_box()
    t0 = jnp.full((N,), 2.0)
    t1 = jnp.full((N,), 4.0)
    ms = sample_medium(
        tables, jnp.zeros((N,), jnp.int32), rays, t0, t1,
        jnp.ones((N, 3)), _keys(seed=3), 0, has_heterogeneous=False,
    )
    est = np.asarray(
        jnp.mean(ms.weight * (~ms.scattered)[:, None].astype(jnp.float32), axis=0)
    )
    expect = np.exp(-sigma_a * 2.0)
    np.testing.assert_allclose(est, expect, rtol=0.12)


def _hetero_tables(dens=0.5, absorption=0.3, scattering=0.2):
    b = SceneBuilder()
    grid = np.full((4, 4, 4), dens, np.float32)
    b.set_density_grid(grid, (-1, -1, -1), (1, 1, 1))
    b.add_heterogeneous_medium(0.0, absorption, scattering)
    return b.build()


def test_density_lookup_constant_and_outside():
    tables = _hetero_tables(0.7)
    p = jnp.asarray([[0.0, 0.0, 0.0], [0.5, -0.5, 0.25], [2.0, 0.0, 0.0]])
    d = np.asarray(density_lookup(tables, p))
    np.testing.assert_allclose(d[:2], 0.7, rtol=1e-5)
    assert d[2] == 0.0  # outside bounds -> background 0 (Src/grid.h:71-77)


def test_density_lookup_trilinear_gradient():
    b = SceneBuilder()
    grid = np.zeros((2, 1, 1), np.float32)
    grid[1] = 1.0  # linear ramp along x
    b.set_density_grid(grid, (0, 0, 0), (1, 1, 1))
    b.add_heterogeneous_medium(0.0, 1.0, 0.0)
    tables = b.build()
    xs = jnp.asarray([[0.25, 0.5, 0.5], [0.75, 0.5, 0.5]])
    d = np.asarray(density_lookup(tables, xs))
    np.testing.assert_allclose(d, [0.25, 0.75], atol=1e-5)


def test_ratio_tracking_matches_analytic():
    """Constant-density hetero grid: ratio tracking expectation equals the
    homogeneous closed form (Src/medium.h:360-386)."""
    tables = _hetero_tables(0.5, 0.4, 0.2)
    p1 = jnp.tile(jnp.asarray([[0.0, 0.0, 0.9]]), (N, 1))
    p2 = jnp.tile(jnp.asarray([[0.0, 0.0, -0.9]]), (N, 1))
    tr = segment_transmittance(
        tables, jnp.zeros((N,), jnp.int32), p1, p2, _keys(seed=7), 0
    )
    est = np.asarray(jnp.mean(tr, axis=0))
    expect = np.exp(-np.asarray([0.6, 0.6, 0.6]) * 0.5 * 1.8)
    np.testing.assert_allclose(est, expect, rtol=0.05)


def test_delta_tracking_unbiased_constant_grid():
    """Constant-density hetero == homogeneous: escape estimator matches
    exp(-sigma_t d) (Src/medium.cpp:45-133)."""
    tables = _hetero_tables(1.0, 0.3, 0.2)
    rays = _rays_through_box()
    t0 = jnp.full((N,), 2.0)
    t1 = jnp.full((N,), 4.0)
    ms = sample_medium(
        tables, jnp.zeros((N,), jnp.int32), rays, t0, t1,
        jnp.ones((N, 3)), _keys(seed=11), 0, max_steps=64,
    )
    est = np.asarray(
        jnp.mean(ms.weight * (~ms.scattered)[:, None].astype(jnp.float32), axis=0)
    )
    expect = np.exp(-0.5 * 2.0)
    np.testing.assert_allclose(est, expect, rtol=0.1)
    # scattered directions are unit
    norm = np.linalg.norm(np.asarray(ms.dir), axis=-1)
    np.testing.assert_allclose(norm, 1.0, atol=1e-4)


def test_tracking_bound_kills_dark():
    """With an absurdly small step bound, exhausted lanes get weight 0 —
    biased dark, never bright (the bounded-loop policy)."""
    tables = _hetero_tables(1.0, 5.0, 5.0)
    rays = _rays_through_box(256)
    t0 = jnp.full((256,), 2.0)
    t1 = jnp.full((256,), 4.0)
    ms = sample_medium(
        tables, jnp.zeros((256,), jnp.int32), rays, t0, t1,
        jnp.ones((256, 3)), _keys(256, seed=13), 0, max_steps=2,
    )
    w = np.asarray(ms.weight)
    done = np.asarray(ms.scattered)
    # every lane either resolved within 2 steps or was zeroed
    assert np.all((w >= 0.0)[~done])


def test_phase_eval_matches_hg():
    tables = _homog_tables(0.1, 0.1)
    wo = jnp.asarray([[0.0, 0.0, 1.0]])
    wi = jnp.asarray([[0.0, 1.0, 0.0]])
    f = np.asarray(eval_phase(tables, jnp.zeros((1,), jnp.int32), wo, wi))
    np.testing.assert_allclose(f, 1.0 / (4 * np.pi), rtol=1e-5)
    # anisotropic check via the warp directly
    g = 0.6
    v = float(hg_phase(jnp.asarray(0.5), g))
    denom = 1 + g * g - 2 * g * 0.5
    np.testing.assert_allclose(
        v, (1 - g * g) / (4 * np.pi * denom ** 1.5), rtol=1e-5
    )


def test_delta_tracking_transmittance_matches_ratio():
    """Both transmittance estimators agree in expectation with the closed
    form on a constant grid (Src/medium.h:321-386)."""
    from xraytracer.media import delta_tracking_transmittance

    tables = _hetero_tables(0.5, 0.4, 0.2)
    p1 = jnp.tile(jnp.asarray([[0.0, 0.0, 0.9]]), (N, 1))
    p2 = jnp.tile(jnp.asarray([[0.0, 0.0, -0.9]]), (N, 1))
    tr = delta_tracking_transmittance(
        tables, jnp.zeros((N,), jnp.int32), p1, p2, _keys(seed=17), 0
    )
    est = np.asarray(jnp.mean(tr, axis=0))
    expect = np.exp(-0.6 * 0.5 * 1.8)
    np.testing.assert_allclose(est, expect, rtol=0.15)


def test_large_max_steps_factory_does_not_crash():
    """A dense grid (majorant x bbox diagonal > 700) auto-derives
    max_steps > 2044; the factory must still build (round-1 VERDICT item 2:
    the fixed NEE site offset used to assert out). Also checks the derived
    bound and that an impossible bound raises a sized ValueError."""
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.integrators.volume import _nee_site_layout
    from xraytracer.media import default_max_steps
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_volume_scene

    tables = build_volume_scene(res=(8, 8, 8), scattering=(3.0, 3.0, 3.0)).build()
    steps = default_max_steps(tables)
    assert steps > 2044  # the configuration that used to crash
    st = scene_statics(tables)
    integ = make_volume_integrator(tables, st, 2, nee=True)  # must not raise
    assert integ is not None
    # layouts at or below the historical bound are bit-identical to round 1
    assert _nee_site_layout(2044) == (8192, 8193, 8208)
    assert _nee_site_layout(128) == (8192, 8193, 8208)
    with pytest.raises(ValueError, match="site budget"):
        _nee_site_layout(20000)


def test_supergrid_sparse_transmittance():
    """Piecewise block-majorant ratio tracking on a SPARSE grid (density in
    one octant only) matches the numerically-integrated transmittance — the
    configuration the supergrid path accelerates (empty blocks cost no
    collision candidates). Also checks the segment decomposition covers the
    whole ray (no truncation bias from the fixed DDA unroll)."""
    from xraytracer.scene.builder import SceneBuilder

    rng = np.random.default_rng(5)
    res = 24
    dens = np.zeros((res, res, res), np.float32)
    dens[16:, 16:, 16:] = rng.random((8, 8, 8), np.float32) * 2.0
    b = SceneBuilder()
    b.set_density_grid(dens, (-1, -1, -1), (1, 1, 1))
    b.add_heterogeneous_medium(0.0, (0.4, 0.4, 0.4), (0.3, 0.3, 0.3))
    tables = b.build()
    # rays along +z through the dense octant (x=y=0.7) and empty space
    for x0, label in ((0.7, "dense"), (-0.5, "empty")):
        n = 8192
        p1 = jnp.tile(jnp.asarray([[x0, 0.7 * (x0 > 0), -1.0]]), (n, 1))
        p2 = jnp.tile(jnp.asarray([[x0, 0.7 * (x0 > 0), 1.0]]), (n, 1))
        tr = segment_transmittance(
            tables, jnp.zeros((n,), jnp.int32), p1, p2,
            _keys(n, seed=11), 0, max_steps=64,
        )
        est = np.asarray(tr).mean(axis=0)
        # numeric reference: midpoint rule over the trilinear field
        ts = np.linspace(0, 1, 4001)[:-1] + 1.0 / 8000
        pts = np.asarray(p1[0])[None, :] * (1 - ts[:, None]) + np.asarray(p2[0])[None, :] * ts[:, None]
        dl = np.asarray(
            density_lookup(tables, jnp.asarray(pts, jnp.float32))
        )
        sigma_t = 0.7
        expect = np.exp(-sigma_t * dl.mean() * 2.0)  # path length 2
        np.testing.assert_allclose(est, expect, rtol=0.05, err_msg=label)
