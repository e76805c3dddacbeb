"""Device-mesh parallelism tests on the 8-device virtual CPU mesh
(SURVEY.md §4d): both sharding axes reproduce the single-device image
bitwise (counter-based RNG)."""

import jax.numpy as jnp
import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import make_path_integrator
from xraytracer.parallel import (
    make_mesh,
    shard_map_render,
    spp_parallel_render,
)
from xraytracer.renderer import make_sample_fn, pixel_grid, render
from xraytracer.scene.builder import scene_statics
from xraytracer.scene.presets import build_cornell_box, cornell_camera

W, H = 32, 32  # 1024 pixels, divisible by 8 devices


def _setup():
    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **cornell_camera())
    integ = make_path_integrator(tables, statics, 2, nee=True)
    return tables, cam, integ


def test_shard_map_pixel_axis_matches_single():
    tables, cam, integ = _setup()
    spp = 3
    ref = render(tables, cam, integ, W, H, spp, seed=7)
    sample_once = make_sample_fn(tables, cam, integ, W, H, seed=7)
    pixel_ids, pixel_xy = pixel_grid(W, H)
    mesh = make_mesh()
    acc, rej = shard_map_render(
        tables, sample_once, pixel_ids, pixel_xy, spp, mesh
    )
    img = np.asarray(acc).reshape(H, W, 3) / spp
    np.testing.assert_allclose(img, ref.image, atol=1e-6)
    assert int(rej) == 0


def test_spp_axis_psum_matches_single():
    tables, cam, integ = _setup()
    spp = 8
    ref = render(tables, cam, integ, W, H, spp, seed=7)
    sample_once = make_sample_fn(tables, cam, integ, W, H, seed=7)
    pixel_ids, pixel_xy = pixel_grid(W, H)
    mesh = make_mesh()
    acc, rej = spp_parallel_render(
        tables, sample_once, pixel_ids, pixel_xy, spp, mesh
    )
    img = np.asarray(acc).reshape(H, W, 3) / spp
    # psum reorders the per-sample additions -> float-assoc tolerance
    np.testing.assert_allclose(img, ref.image, atol=1e-5)
    assert int(rej) == 0


def test_spp_axis_uneven_spp():
    """spp not divisible by the device count still covers every sample
    exactly once."""
    tables, cam, integ = _setup()
    spp = 5  # 8 devices, uneven
    ref = render(tables, cam, integ, W, H, spp, seed=3)
    sample_once = make_sample_fn(tables, cam, integ, W, H, seed=3)
    pixel_ids, pixel_xy = pixel_grid(W, H)
    mesh = make_mesh()
    acc, _ = spp_parallel_render(
        tables, sample_once, pixel_ids, pixel_xy, spp, mesh
    )
    img = np.asarray(acc).reshape(H, W, 3) / spp
    np.testing.assert_allclose(img, ref.image, atol=1e-5)
