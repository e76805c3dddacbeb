import os

import jax
import jax.numpy as jnp
import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer import film
from xraytracer.math import from_rows
from xraytracer.scene import (
    SceneBuilder,
    load_obj_into,
    parse_obj,
    scene_statics,
)
from xraytracer.scene.presets import (
    build_cornell_box,
    preset_cornellbox,
    preset_vpt,
    build_volume_scene,
)

OBJ = """
mtllib t.mtl
o tri
usemtl red
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
o quad_neg
usemtl none_mat
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f -4 -3 -2 -1
o empty_shape
usemtl red
"""

MTL = """
newmtl red
Kd 1 0 0
newmtl none_mat
Kd 0.5 0.5 0.5
no_surface
"""


def write_fixture(tmp_path):
    (tmp_path / "t.obj").write_text(OBJ)
    (tmp_path / "t.mtl").write_text(MTL)
    return str(tmp_path / "t.obj")


def test_parse_obj_shapes(tmp_path):
    path = write_fixture(tmp_path)
    shapes, mats = parse_obj(path)
    assert len(shapes) == 2  # empty shape dropped
    assert shapes[0]["material"] == "red"
    assert shapes[0]["vertices"].shape == (1, 3, 3)
    # quad fan-triangulated with negative indices resolved
    assert shapes[1]["vertices"].shape == (2, 3, 3)
    np.testing.assert_allclose(shapes[1]["vertices"][0][0], [0, 0, 1])
    assert mats["none_mat"]["no_surface"]
    assert mats["red"]["Kd"] == (1.0, 0.0, 0.0)


def test_load_obj_into_builder(tmp_path):
    path = write_fixture(tmp_path)
    b = SceneBuilder()
    objs = load_obj_into(b, path)
    s = b.build()
    assert len(objs) == 2
    # red lambert on object 0; no_surface -> mat -1 on object 1
    assert int(s.obj_mat[objs[0]]) == 0
    np.testing.assert_allclose(np.asarray(s.mat_albedo[0]), [1, 0, 0])
    assert int(s.obj_mat[objs[1]]) == -1
    # 3 real triangles, padded to TRI_PAD multiple with obj -1 sentinels
    assert int((s.tri_obj >= 0).sum()) == 3
    # padded to an 8-multiple (<=128) or 128-multiple (larger scenes)
    assert s.tri_v0.shape[0] % 8 == 0


def test_cornell_box_tables():
    s = build_cornell_box().build()
    st = scene_statics(s)
    assert st["n_area_lights"] == 1
    assert not st["has_media"]
    # 17 quads = 34 wall/block tris + 2 emissive light tris
    assert int((s.tri_obj >= 0).sum()) == 36
    # light object: last object, no material, light id 0
    light_objs = np.asarray(s.obj_light)
    assert (light_objs >= 0).sum() == 1
    lo = int(np.argmax(light_objs >= 0))
    assert int(s.obj_mat[lo]) == -1
    # quad light pdf precursors: ng = cross(e1,e2), |ng| = quad area
    area = np.linalg.norm(np.asarray(s.al_ng[0]))
    np.testing.assert_allclose(area, 130.0 * 105.0, rtol=1e-5)


def test_presets_build():
    for fn in (preset_cornellbox, preset_vpt):
        tables, cam_kwargs, render_kwargs = fn()
        assert tables.tri_v0.shape[0] >= 1
        assert "c2w" in cam_kwargs and render_kwargs["spp"] > 0


def test_volume_scene_majorant():
    b = build_volume_scene(res=(16, 16, 16))
    s = b.build()
    st = scene_statics(s)
    assert st["has_heterogeneous"] and st["n_area_lights"] == 1
    dmax = float(np.asarray(s.grid_density).max())
    # majorant = max over channels of (abs+scat)*max_density (medium.cpp:11-17)
    np.testing.assert_allclose(float(s.med_majorant[0]), 1.0 * dmax, rtol=1e-6)


def test_camera_center_ray():
    cam = PinholeCamera.make(1.0, from_rows(
        1, 0, 0, 0,
        0, 1, 0, 0,
        0, 0, 1, 0,
        0, 0, 5, 1,
    ), fov_deg=90.0)
    rays = cam.sample_rays(jnp.asarray([[0.5, 0.5], [1.0, 0.5]], jnp.float32))
    o, d = np.asarray(rays.o), np.asarray(rays.d)
    np.testing.assert_allclose(o[0], [0, 0, 5], atol=1e-6)
    np.testing.assert_allclose(d[0], [0, 0, -1], atol=1e-6)
    # right edge at fov 90: 45 degrees off axis
    np.testing.assert_allclose(d[1], [np.sqrt(0.5), 0, -np.sqrt(0.5)], atol=1e-5)


def test_camera_reference_cornell_orientation():
    cam_kwargs = preset_cornellbox()[1]
    cam = PinholeCamera.make(780.0 / 585.0, **cam_kwargs)
    rays = cam.sample_rays(jnp.asarray([[0.5, 0.5]], jnp.float32))
    d = np.asarray(rays.d)[0]
    np.testing.assert_allclose(d, [0, 0, 1], atol=1e-6)  # c2w flips z
    np.testing.assert_allclose(np.asarray(rays.o)[0], [278, 274.4, -750.0])


def test_film_roundtrip(tmp_path):
    img = jnp.asarray(np.random.default_rng(0).random((4, 5, 3)), jnp.float32)
    u8 = film.to_u8(film.gamma_correct(img, 2.2))
    assert u8.shape == (4, 5, 3) and u8.dtype == np.uint8
    p = tmp_path / "x.ppm"
    film.write_ppm(str(p), u8)
    txt = p.read_text().split()
    assert txt[0] == "P3" and txt[1] == "5" and txt[2] == "4"
    png = tmp_path / "x.png"
    film.write_png(str(png), u8)
    data = png.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IEND" in data


def test_density_grid_ingest_end_to_end(tmp_path):
    """The --density-grid data path (grid_convert .npz -> .npy -> CLI scene
    build -> render) runs on the checked-in cloud fixture, without
    pyopenvdb (round-1 VERDICT item 6)."""
    import os

    from xraytracer.camera import PinholeCamera
    from xraytracer.cli import build_scene
    from xraytracer.config import get_preset
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.renderer import render
    from xraytracer.tools.grid_convert import main as convert_main

    fixture = os.path.join(os.path.dirname(__file__), "data", "cloud_32.npz")
    out = str(tmp_path / "cloud.npy")
    convert_main([fixture, out])
    npy = np.load(out)
    assert npy.shape == (32, 32, 32) and npy.max() > 0.5

    cfg = get_preset("nee", width=24, height=24, spp=2, max_depth=3)
    tables, cam_kwargs = build_scene(cfg, density_grid=out)
    # the fixture grid (not the procedural cloud) is live in the tables
    np.testing.assert_allclose(
        np.asarray(tables.grid_density), npy, rtol=1e-6
    )
    statics = scene_statics(tables)
    cam = PinholeCamera.make(1.0, **cam_kwargs)
    integ = make_volume_integrator(tables, statics, 3, nee=True, max_steps=64)
    r = render(tables, cam, integ, 24, 24, 2, seed=0)
    assert np.isfinite(r.image).all()
    assert r.image.max() > 0.0  # the sphere light is visible through the cloud
