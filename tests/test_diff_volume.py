"""Differentiable volume rendering: reverse-mode through the bounded-trip
tracking loops matches finite differences (SURVEY.md §7 step 9 extended to
media: gradients w.r.t. sigma, Le, and the density grid)."""

import jax
import jax.numpy as jnp
import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import make_volume_integrator
from xraytracer.renderer import CAMERA_SITE, pixel_grid
from xraytracer.sampling import path_keys, uniform2
from xraytracer.scene.builder import SceneBuilder, scene_statics
from xraytracer.math import from_rows

W, H = 8, 6


def _hetero_scene():
    b = SceneBuilder()
    grid = np.full((4, 4, 4), 0.6, np.float32)
    grid[1:3, 1:3, 1:3] = 1.0
    b.set_density_grid(grid, (-1, -1, -1), (1, 1, 1))
    b.add_heterogeneous_medium(0.0, (0.2, 0.2, 0.2), (0.4, 0.4, 0.4))
    b.add_quad_light((0.5, 1.6, 0.5), (-0.5, 1.6, 0.5), (0.5, 1.6, -0.5),
                     (8.0, 8.0, 8.0))
    return b.build()


def _radiance_fn(tables, nee):
    statics = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 4.0, 1)
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=50.0)
    pixel_ids, pixel_xy = pixel_grid(W, H)
    wh = jnp.asarray([float(W), float(H)])

    def f(params):
        scene = tables._replace(**params)
        integ = make_volume_integrator(
            scene, statics, max_depth=3, nee=nee, max_steps=24,
            differentiable=True,
        )
        keys = path_keys(0, pixel_ids, 0)
        u = uniform2(keys, CAMERA_SITE)
        rays = cam.sample_rays((pixel_xy + u) / wh)
        return jnp.mean(integ(rays, keys))

    return jax.jit(f)


def _check_fd(f, params, key, idx, eps, rtol=0.08, atol=2e-4):
    g = jax.jit(jax.grad(f))(params)[key]
    for i in idx:
        dp = jnp.zeros_like(params[key])
        dp = dp.reshape(-1).at[i].set(eps).reshape(params[key].shape)
        fd = (float(f({**params, key: params[key] + dp}))
              - float(f({**params, key: params[key] - dp}))) / (2 * eps)
        ad = float(np.asarray(g).reshape(-1)[i])
        assert np.isfinite(ad)
        assert abs(fd - ad) <= max(atol, rtol * abs(fd)), (key, i, fd, ad)


def test_sigma_s_gradient_matches_fd():
    tables = _hetero_scene()
    f = _radiance_fn(tables, nee=False)
    params = {"med_sigma_s": tables.med_sigma_s}
    _check_fd(f, params, "med_sigma_s", [0, 1], eps=5e-3)


def test_density_grid_gradient_nonzero_and_fd():
    tables = _hetero_scene()
    f = _radiance_fn(tables, nee=True)
    params = {"grid_density": tables.grid_density}
    g = jax.jit(jax.grad(f))(params)["grid_density"]
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).sum()) > 0.0
    # finite-difference a center voxel (index 21 = (1,1,1) in 4x4x4)
    _check_fd(f, params, "grid_density", [21], eps=2e-2, rtol=0.1)


def test_le_gradient_through_volume_nee():
    tables = _hetero_scene()
    f = _radiance_fn(tables, nee=True)
    params = {"al_le": tables.al_le}
    _check_fd(f, params, "al_le", [0], eps=5e-2)


def test_density_descent_recovers_blob():
    """Gradient DESCENT on the density grid recovers a coarse blob from
    target renders — the round-3 verdict's capability hole. Two
    ingredients turn the validate-only gradients into usable ones:

    * ``score_terms=True`` (media._score_ratio): detached sampling drops
      the tracking decisions' score term, and descent then DIVERGES
      (measured: density saturates to ~0.96 everywhere); the corrected
      estimator adds ``p/stop_grad(p)`` factors per sampled event.
    * a TWO-SAMPLE product loss: E[(a-t)(b-t)] with independent renders
      a, b estimates (E img - t)^2 without the Var(img) term a plain L2
      on a noisy render minimizes (which collapses density to 0 — zero
      variance).

    Tables are built with a ones grid so the baked majorants bound any
    density in [0, 1]; the blob is parameterized through a sigmoid.
    Deterministic: fixed counter-based streams end to end.
    """
    import optax

    from xraytracer.renderer import pixel_grid

    W2, H2 = 16, 12
    b = SceneBuilder()
    b.set_density_grid(np.ones((4, 4, 4), np.float32), (-1, -1, -1),
                       (1, 1, 1))
    b.add_heterogeneous_medium(0.0, (0.2, 0.2, 0.2), (0.4, 0.4, 0.4))
    b.add_quad_light((0.5, 1.6, 0.5), (-0.5, 1.6, 0.5), (0.5, 1.6, -0.5),
                     (8.0, 8.0, 8.0))
    tables = b.build()
    statics = scene_statics(tables)
    cams = [
        PinholeCamera.make(W2 / H2, c2w=from_rows(
            1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 4.0, 1),
            fov_deg=50.0),
        PinholeCamera.make(W2 / H2, c2w=from_rows(
            0, 0, -1.0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 0, 4.0, 0, 0, 1),
            fov_deg=50.0),
    ]
    cam4 = jax.tree.map(lambda *x: jnp.stack(x), *(cams + cams))
    pixel_ids, pixel_xy = pixel_grid(W2, H2)
    wh = jnp.asarray([float(W2), float(H2)])

    def render_one(dens, cam, keys, score):
        scene = tables._replace(grid_density=dens)
        integ = make_volume_integrator(
            scene, statics, max_depth=3, nee=True, max_steps=20,
            differentiable=True, score_terms=score,
        )
        u = uniform2(keys, CAMERA_SITE)
        rays = cam.sample_rays((pixel_xy + u) / wh)
        return integ(rays, keys)

    def keys4(s):
        return jnp.stack([path_keys(0, pixel_ids, 2 * s),
                          path_keys(7919, pixel_ids, 2 * s),
                          path_keys(0, pixel_ids, 2 * s + 1),
                          path_keys(7919, pixel_ids, 2 * s + 1)])

    tgt = np.full((4, 4, 4), 0.25, np.float32)
    tgt[1:3, 1:3, 1:3] = 0.85
    tgt_d = jnp.asarray(tgt)
    tf = jax.jit(lambda s: jax.vmap(
        render_one, in_axes=(None, 0, 0, None)
    )(tgt_d, cam4, keys4(s), False)[:2])
    timg = jnp.asarray(
        np.mean([np.asarray(tf(s)) for s in range(48)], axis=0)
    )

    def loss(z, s):
        dens = jax.nn.sigmoid(z)
        imgs = jax.vmap(render_one, in_axes=(None, 0, 0, None))(
            dens, cam4, keys4(s), True
        )
        a, bb = imgs[:2], imgs[2:]
        return jnp.mean((a - timg) * (bb - timg))

    vg = jax.jit(jax.value_and_grad(loss))
    z = jnp.zeros((4, 4, 4))
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.08))
    st = opt.init(z)
    mae0 = float(jnp.abs(jax.nn.sigmoid(z) - tgt).mean())
    for step in range(400):
        _, g = vg(z, 1000 + step)
        up, st = opt.update(g, st)
        z = optax.apply_updates(z, up)
    d = np.asarray(jax.nn.sigmoid(z))
    mae = float(np.abs(d - tgt).mean())
    center = float(d[1:3, 1:3, 1:3].mean())
    outer = float((d.sum() - d[1:3, 1:3, 1:3].sum()) / 56)
    assert np.isfinite(d).all()
    # recovery: the blob emerges (center 0.5 -> toward 0.85, outer
    # toward 0.25) and overall error drops (measured: mae 0.263 -> 0.202,
    # center 0.651, outer 0.318 at these exact streams)
    assert mae < 0.85 * mae0, (mae, mae0)
    assert center > 0.58, center
    assert center - outer > 0.2, (center, outer)
