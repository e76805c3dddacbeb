"""Tests that need a GPU (marker ``gpu``). They skip on the CPU mesh;
``chip_smoke.py`` runs them on the card in its own process."""

import re

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _gi_step_hlo(width=64, height=48):
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.renderer import make_sample_fn, pixel_grid
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    tables = build_cornell_box().build()
    camera = PinholeCamera.make(width / height, **cornell_camera())
    integrate = make_path_integrator(
        tables, scene_statics(tables), 3, nee=True)
    sample = make_sample_fn(tables, camera, integrate, width, height, 0)
    ids, xy = pixel_grid(width, height)
    return jax.jit(sample).lower(ids, xy, 0).compile().as_text()


def test_gi_step_has_no_reduced_precision_dot(gpu_device):
    """The optimised GPU program of the GI step keeps every matrix product
    at full float32: no TF32 or bf16 algorithm survives, and every dot or
    GEMM call carries HIGHEST precision."""
    hlo = _gi_step_hlo()
    lowered = hlo.lower()
    assert "tf32" not in lowered
    assert "bf16" not in lowered
    dots = [line for line in hlo.splitlines()
            if re.search(r"\bdot\(|__cublas\$gemm|__cublas\$lt", line)]
    for line in dots:
        assert "highest" in line.lower(), line


def test_sweeps_agree_with_float64_on_card(gpu_device):
    """Both triangle sweeps on the card against the float64 reference on a
    random scene: same winner on (almost) every ray, t to float32
    accuracy."""
    import chip_smoke
    from xraytracer.geometry import Rays
    from xraytracer.geometry.intersect import (
        intersect_triangles,
        intersect_triangles_mm,
    )
    from xraytracer.scene import SceneBuilder

    rng = np.random.default_rng(0)
    b = SceneBuilder()
    b.add_mesh(rng.uniform(-5, 5, (512, 3, 3)).astype(np.float32),
               material=b.add_lambert((1, 1, 1)))
    s = b.build()
    n = 8192
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (Rays(o=jax.device_put(o, gpu_device),
                 d=jax.device_put(d, gpu_device)),
            s.tri_v0, s.tri_e1, s.tri_e2, s.tri_obj >= 0)
    t64, i64 = chip_smoke.mt_float64(o, d, *(np.asarray(a) for a in args[1:]))
    for fn in (intersect_triangles_mm, intersect_triangles):
        t, i, _, _ = jax.jit(fn)(*args)
        t, i = np.asarray(t, np.float64), np.asarray(i)
        assert (i == i64).mean() > 0.999
        same = (i == i64) & (i64 >= 0)
        # t's float32 error scales with the scene's extent (~10 units)
        np.testing.assert_allclose(t[same], t64[same], rtol=2e-4, atol=1e-5)
