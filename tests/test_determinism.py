"""Wavefront determinism across the renderer's execution choices, for
surface, homogeneous-volume and heterogeneous-volume scenes: the image is a
function of (scene, seed, pixel, sample) only, whatever the lane order,
spp chunking, checkpoint history or device count."""

import logging
import os

import jax
import numpy as np
import pytest

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import make_path_integrator, make_volume_integrator
from xraytracer.math import from_rows
from xraytracer.renderer import (
    Accumulator,
    WavefrontRenderer,
    default_mesh,
    pixel_sharding,
)
from xraytracer.scene.builder import scene_statics
from xraytracer.scene.presets import (
    build_cornell_box,
    build_volume_scene,
    cornell_camera,
    preset_vpt,
)

W, H = 16, 8   # 128 pixels: divisible by the 8-device mesh
KINDS = ["surface", "vpt", "heterogeneous"]
# enough samples that every kind's image is not black at this size
SPP = {"surface": 2, "vpt": 8, "heterogeneous": 2}


def _setup(kind):
    if kind == "surface":
        tables = build_cornell_box().build()
        cam_kwargs = cornell_camera()
        integ = make_path_integrator(tables, scene_statics(tables), 2,
                                     nee=True)
    elif kind == "vpt":
        tables, cam_kwargs, _ = preset_vpt()
        integ = make_volume_integrator(tables, scene_statics(tables), 3)
    else:
        tables = build_volume_scene(
            res=(8, 8, 8), absorption=(0.01, 0.01, 0.01),
            scattering=(0.05, 0.05, 0.05), le=30.0,
            light_center=(0.0, 400.0, 0.0),
        ).build()
        cam_kwargs = dict(c2w=from_rows(
            1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1),
            fov_deg=60.0)
        integ = make_volume_integrator(tables, scene_statics(tables), 3,
                                       nee=True, max_steps=32)
    camera = PinholeCamera.make(W / H, **cam_kwargs)
    return tables, camera, integ


def _renderer(kind, **kw):
    tables, camera, integ = _setup(kind)
    return WavefrontRenderer(tables, camera, integ, W, H, seed=11, **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_raster_and_morton_orders_give_one_image(kind):
    a = _renderer(kind, pixel_order="raster").render(SPP[kind])
    b = _renderer(kind, pixel_order="morton").render(SPP[kind])
    assert np.abs(a.image).sum() > 0.0
    np.testing.assert_array_equal(a.image, b.image)


@pytest.mark.parametrize("kind", KINDS)
def test_spp_chunking_gives_one_image(kind):
    r = _renderer(kind)
    whole = r.render(3)
    chunked = r.render(3, spp_chunk=1)
    np.testing.assert_array_equal(whole.image, chunked.image)
    assert whole.n_rejected == chunked.n_rejected


@pytest.mark.parametrize("first,second", [("raster", "morton"),
                                          ("morton", "raster")])
def test_checkpoint_resume_across_pixel_orders(tmp_path, first, second):
    ckpt = os.path.join(tmp_path, "acc.npz")
    _renderer("surface", pixel_order=first).render(2, checkpoint_path=ckpt)
    acc = Accumulator.load(ckpt)
    assert acc.spp_done == 2
    resumed = _renderer("surface", pixel_order=second).render(
        4, accumulator=acc)
    full = _renderer("surface", pixel_order="raster").render(4)
    np.testing.assert_array_equal(resumed.image, full.image)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_render_matches_single_device(kind):
    mesh = default_mesh()
    assert mesh.size == 8  # conftest forces 8 virtual devices
    single = _renderer(kind).render(SPP[kind])
    sharded = _renderer(kind, sharding=pixel_sharding(mesh)).render(SPP[kind])
    assert sharded.n_rejected == single.n_rejected
    np.testing.assert_allclose(sharded.image, single.image, atol=1e-6)


def test_sharded_renderer_compiles_its_step_once(caplog):
    """A held sharded renderer compiles its step on the first render only:
    the rejected count enters replicated, as the step returns it."""
    r = _renderer("surface", sharding=pixel_sharding(default_mesh()))
    r.render(1)
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING):
            r.render(3)
            r.render(2)
    finally:
        jax.config.update("jax_log_compiles", False)
    compiles = [m for m in caplog.messages if m.startswith("Compiling jit(step)")]
    assert not compiles, compiles
