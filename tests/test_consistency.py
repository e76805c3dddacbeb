"""Cross-estimator consistency gates: independent estimators of the same
integral must agree in expectation (catches pdf/weight bugs that
single-estimator statistical tests cannot)."""

import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import (
    make_path_integrator,
    make_volume_integrator,
)
from xraytracer.math import from_rows
from xraytracer.renderer import render
from xraytracer.scene.builder import SceneBuilder, scene_statics
from xraytracer.scene.presets import build_cornell_box, cornell_camera


def test_gi_equals_indirect_in_expectation():
    """GI (NEE) and Indirect (BSDF-only) estimate the same transport; their
    converged means must agree (no-MIS double-count bugs would split them).

    Depth accounting: GI connects to the light at EVERY surface vertex
    (including the last), so GI at max_depth=d covers the same maximum path
    length as Indirect at max_depth=d+1 (whose last vertex must HIT the
    light via BSDF sampling) — exactly the reference's loop structures
    (Src/integrator.h:158-166 vs 236-267)."""
    W, H = 24, 18
    tables = build_cornell_box().build()
    st = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **cornell_camera())
    r_gi = render(
        tables, cam, make_path_integrator(tables, st, 2, nee=True),
        W, H, 256, seed=1,
    )
    r_in = render(
        tables, cam, make_path_integrator(tables, st, 3, nee=False),
        W, H, 1024, seed=2,
    )
    np.testing.assert_allclose(r_gi.image.mean(), r_in.image.mean(), rtol=0.05)


def test_vpt_equals_vpt_nee_in_expectation():
    """VolumePathTracing and its NEE variant estimate the same integral on a
    homogeneous slab + quad light."""
    W, H = 16, 16
    b = SceneBuilder()
    b.add_homogeneous_medium(
        0.3, (0.2, 0.2, 0.2), (0.6, 0.6, 0.6), (-1, -1, -1), (1, 1, 1)
    )
    b.add_quad_light((0.5, 1.5, 0.5), (-0.5, 1.5, 0.5), (0.5, 1.5, -0.5),
                     (6.0, 6.0, 6.0))
    tables = b.build()
    st = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 4.0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=45.0)
    r_pt = render(
        tables, cam,
        make_volume_integrator(tables, st, 6, nee=False, max_steps=32),
        W, H, 1024, seed=3,
    )
    r_nee = render(
        tables, cam,
        make_volume_integrator(tables, st, 6, nee=True, max_steps=32),
        W, H, 256, seed=4,
    )
    # NEE adds the emitter-visible-from-scatter paths the PT variant finds
    # by chance; means agree within MC noise at these sample counts
    np.testing.assert_allclose(
        r_pt.image.mean(), r_nee.image.mean(), rtol=0.08
    )


def test_gi_mis_equals_gi_in_expectation():
    """The power-heuristic MIS estimator (beyond the reference) computes the
    same integral as plain NEE GI. Uses a LARGE, close light so the BSDF-hit
    branch carries real weight (on Cornell's small distant lamp the MIS
    weights collapse to NEE ~1 / BSDF ~0 and the test would be vacuous)."""
    W, H = 16, 16
    b = SceneBuilder()
    floor = np.asarray(
        [
            [[-4, 0, -4], [4, 0, -4], [-4, 0, 4]],
            [[4, 0, -4], [4, 0, 4], [-4, 0, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=b.add_lambert((0.7, 0.7, 0.7)))
    # 4x4 quad light 1.5 units up, facing down: large solid angle
    b.add_quad_light((-2, 1.5, -2), (2, 1.5, -2), (-2, 1.5, 2), (2, 2, 2))
    tables = b.build()
    st = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.7, 5.0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=50.0)
    r_gi = render(
        tables, cam, make_path_integrator(tables, st, 3, nee=True),
        W, H, 512, seed=5,
    )
    r_mis = render(
        tables, cam, make_path_integrator(tables, st, 3, mis=True),
        W, H, 512, seed=6,
    )
    np.testing.assert_allclose(
        r_mis.image.mean(), r_gi.image.mean(), rtol=0.05
    )
    # MIS must not reintroduce NaNs or negatives
    assert r_mis.n_rejected == 0


def test_gi_mis_with_specular_paths():
    """MIS through delta lobes: emitter hits after a mirror bounce must get
    full weight (NEE cannot sample through a delta BSDF)."""
    W, H = 16, 12
    b = SceneBuilder()
    floor = np.asarray(
        [
            [[-4, 0, -4], [4, 0, -4], [-4, 0, 4]],
            [[4, 0, -4], [4, 0, 4], [-4, 0, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=b.add_mirror((0.9, 0.9, 0.9)))
    b.add_quad_light((-1, 3, -1), (1, 3, -1), (-1, 3, 1), (4, 4, 4))
    tables = b.build()
    st = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.5, 6.0, 1)
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=40.0)
    r_mis = render(
        tables, cam, make_path_integrator(tables, st, 3, mis=True),
        W, H, 64, seed=9,
    )
    r_gi = render(
        tables, cam, make_path_integrator(tables, st, 3, nee=False,
                                          le_depth0_only=False),
        W, H, 64, seed=9,
    )
    assert r_mis.n_rejected == 0
    # mirror floor reflects the light: the image must show it, and since NEE
    # contributes nothing on pure-specular surfaces, MIS == BSDF-only here
    assert r_mis.image.max() > 1.0
    np.testing.assert_allclose(r_mis.image, r_gi.image, atol=1e-5)
