"""Every float32 contraction on the render and gradient paths asks for
``Precision.HIGHEST``: a jaxpr walk over each entry point. On GPUs XLA may
run an unpinned f32 matmul in TF32, which flips hit/miss decisions."""

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from xraytracer.camera import PinholeCamera
from xraytracer.diff import make_radiance_fn, make_train_step
from xraytracer.geometry import Rays
from xraytracer.geometry import intersect as xi
from xraytracer.integrators import (
    make_direct_integrator,
    make_path_integrator,
    make_volume_integrator,
    make_whitted_integrator,
)
from xraytracer.math import from_rows, transform_point
from xraytracer.renderer import make_sample_fn, pixel_grid
from xraytracer.sampling import path_keys
from xraytracer.scene.builder import SceneBuilder, scene_statics
from xraytracer.scene.presets import (
    build_cornell_box,
    build_volume_scene,
    cornell_camera,
    preset_example,
    preset_vpt,
)

N = 16
W, H = 4, 4


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in ``jaxpr`` and its
    sub-jaxprs (scan/while/cond/pjit/custom rules)."""
    found = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jex.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _rays(n=N, seed=0, center=(278.0, 274.0, -700.0), spread=50.0):
    rng = np.random.default_rng(seed)
    o = np.asarray(center, np.float32) + rng.uniform(
        -spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Rays(o=jnp.asarray(o), d=jnp.asarray(d))


def _cornell():
    t = build_cornell_box().build()
    return t, scene_statics(t), PinholeCamera.make(W / H, **cornell_camera())


def _sample_fn(tables, cam, integ):
    ids, xy = pixel_grid(W, H)
    f = make_sample_fn(tables, cam, integ, W, H, 0)
    return lambda: f(ids, xy, 0)


def _mixed_scene():
    b = SceneBuilder()
    m = b.add_lambert((0.5, 0.5, 0.5))
    b.add_mesh(np.asarray([[[-2, -2, 2], [2, -2, 2], [0, 2, 2]]],
                          np.float32), material=m)
    b.add_sphere((0, 0, 0), 1.0, material=m)
    b.add_homogeneous_medium(0.0, 0.5, 0.5, (-4, -4, -4), (4, 4, 4))
    return b.build()


def _case(name):
    if name == "camera":
        _, _, cam = _cornell()
        return lambda: cam.sample_rays(jnp.full((N, 2), 0.3))
    if name == "transform_point":
        m = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 1, 2, 3, 1)
        return lambda: transform_point(m, jnp.ones((N, 3)))
    if name in ("sweep_classic", "sweep_mm"):
        t, _, _ = _cornell()
        fn = xi.intersect_triangles if name == "sweep_classic" else (
            xi.intersect_triangles_mm)
        return lambda: fn(_rays(), t.tri_v0, t.tri_e1, t.tri_e2,
                          t.tri_obj >= 0)
    if name == "spheres":
        s = _mixed_scene()
        return lambda: xi.intersect_spheres(
            _rays(center=(0, 0, 6), spread=1.0), s.sph_center,
            s.sph_radius, s.sph_obj >= 0)
    if name == "intersect_scene_cornell":
        t, _, _ = _cornell()
        return lambda: xi.intersect_scene(t, _rays())
    if name == "intersect_scene_mixed":
        s = _mixed_scene()
        return lambda: xi.intersect_scene(s, _rays(center=(0, 0, 6),
                                                   spread=1.0))
    if name == "occluded":
        t, _, _ = _cornell()
        return lambda: xi.occluded(t, _rays(), jnp.full((N,), 500.0))
    if name.startswith("gi_"):
        t, st, cam = _cornell()
        mode = name[3:]
        integ = (make_path_integrator(t, st, 3, mis=True) if mode == "mis"
                 else make_path_integrator(t, st, 3, nee=True,
                                           nee_mode=mode))
        return _sample_fn(t, cam, integ)
    if name == "whitted":
        t, ck, _ = preset_example()
        cam = PinholeCamera.make(W / H, **ck)
        return _sample_fn(t, cam, make_whitted_integrator(
            t, scene_statics(t), 3))
    if name == "direct":
        t, st, cam = _cornell()
        return _sample_fn(t, cam, make_direct_integrator(t, st))
    if name in ("vpt", "vpt_nee_grid"):
        if name == "vpt":
            t, ck, _ = preset_vpt()
        else:
            t = build_volume_scene(res=(8, 8, 8)).build()
            ck = dict(c2w=from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0,
                                    0, 70.0, 550.0, 1), fov_deg=60.0)
        cam = PinholeCamera.make(W / H, **ck)
        integ = make_volume_integrator(t, scene_statics(t), 3,
                                       nee=name != "vpt", max_steps=8)
        return _sample_fn(t, cam, integ)
    if name == "diff_train_step":
        t, st, cam = _cornell()
        ids, xy = pixel_grid(W, H)
        step = make_train_step(make_radiance_fn(t, st, cam, W, H,
                                                max_depth=2))
        params = {"mat_albedo": t.mat_albedo, "al_le": t.al_le}
        return lambda: step(params, ids, xy, jnp.zeros((W * H, 3)), 0)
    if name == "volume_density_grad":
        t = build_volume_scene(res=(4, 4, 4)).build()
        st = scene_statics(t)
        ids, _ = pixel_grid(W, H)
        rays = _rays(center=(0, 70, 550), spread=5.0)
        rays = Rays(o=rays.o, d=-rays.d)

        def loss(dens):
            integ = make_volume_integrator(
                t._replace(grid_density=dens), st, 2, nee=True,
                max_steps=4, differentiable=True, score_terms=True)
            return jnp.mean(integ(rays, path_keys(0, ids, 0)))

        return lambda: jax.grad(loss)(t.grid_density)
    raise KeyError(name)


CASES = [
    "camera", "transform_point", "sweep_classic", "sweep_mm", "spheres",
    "intersect_scene_cornell", "intersect_scene_mixed", "occluded",
    "gi_all", "gi_one", "gi_power", "gi_mis", "whitted", "direct", "vpt",
    "vpt_nee_grid", "diff_train_step", "volume_density_grad",
]


@pytest.mark.parametrize("name", CASES)
def test_every_dot_is_highest(name):
    precisions = _dot_precisions(jax.make_jaxpr(_case(name))())
    assert precisions, f"{name}: no dot_general traced"
    hi = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    bad = [p for p in precisions if p != hi]
    assert not bad, f"{name}: {len(bad)} of {len(precisions)} dots not HIGHEST: {bad[:3]}"
