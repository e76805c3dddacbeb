"""Integrator-level tests: cross-integrator consistency, analytic direct
lighting, renderer determinism/chunking/sharding/checkpointing."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import (
    make_direct_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_whitted_integrator,
)
from xraytracer.math import from_rows
from xraytracer.renderer import (
    Accumulator,
    default_mesh,
    pixel_sharding,
    render,
)
from xraytracer.scene.builder import SceneBuilder, scene_statics
from xraytracer.scene.presets import build_cornell_box, cornell_camera

W, H = 40, 30


def _cornell():
    tables = build_cornell_box().build()
    return tables, scene_statics(tables), PinholeCamera.make(W / H, **cornell_camera())


def test_normal_integrator_range():
    tables, statics, cam = _cornell()
    r = render(tables, cam, make_normal_integrator(tables), W, H, 1)
    assert r.image.min() >= 0.0 and r.image.max() <= 1.0
    # a large fraction of pixels see a surface whose normal faces the
    # camera (-z): back wall / block fronts -> viz 0.5*(n+1) = (.5, .5, 0)
    frontish = np.isclose(r.image, [0.5, 0.5, 0.0], atol=1e-3).all(-1)
    assert frontish.mean() > 0.08


def test_gi_depth1_equals_direct_on_hits():
    """GI with max_depth=1 = emitter Le + one NEE bounce = Direct integrator
    on every pixel that hits geometry (the only divergence is the miss
    background: 0 vs 0.18, Src/integrator.h:114)."""
    tables, statics, _ = _cornell()
    # narrow the FOV so every primary ray hits geometry (at fov 60 the frame
    # edges miss the open Cornell front and the two integrators differ only
    # in their background constant)
    cam = PinholeCamera.make(W / H, c2w=cornell_camera()["c2w"], fov_deg=40.0)
    r_gi = render(
        tables, cam,
        make_path_integrator(tables, statics, max_depth=1, nee=True),
        W, H, 4, seed=5,
    )
    r_di = render(
        tables, cam, make_direct_integrator(tables, statics), W, H, 4, seed=5
    )
    np.testing.assert_allclose(r_gi.image, r_di.image, atol=1e-5)


def test_gi_brightens_with_depth():
    """More bounces can only add energy (all terms non-negative)."""
    tables, statics, cam = _cornell()
    imgs = []
    for depth in (1, 3):
        r = render(
            tables, cam,
            make_path_integrator(tables, statics, max_depth=depth, nee=True),
            W, H, 8, seed=2,
        )
        imgs.append(r.image.mean())
    assert imgs[1] > imgs[0]


def test_uniform_vs_cosine_sampling_agree():
    """Both Lambert sampling strategies estimate the same integral."""
    tables, statics, cam = _cornell()
    r_u = render(
        tables, cam,
        make_path_integrator(tables, statics, 3, nee=True, cosine_sampling=False),
        W, H, 64, seed=1,
    )
    r_c = render(
        tables, cam,
        make_path_integrator(tables, statics, 3, nee=True, cosine_sampling=True),
        W, H, 64, seed=2,
    )
    # compare downsampled means (MC noise at 64 spp)
    np.testing.assert_allclose(r_u.image.mean(), r_c.image.mean(), rtol=0.05)


def test_whitted_mirror_glass_live():
    """Mirror and Glass branches are reachable (unlike the reference, where
    MaterialType::Metals/Glass have no classes — Src/integrator.h:344-381)."""
    b = SceneBuilder()
    floor = np.asarray(
        [
            [[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
            [[10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=b.add_lambert((0.8, 0.2, 0.2)))
    b.add_sphere((-1.5, 1.0, 0.0), 1.0, material=b.add_mirror())
    b.add_sphere((1.5, 1.0, 0.0), 1.0, material=b.add_glass())
    b.add_point_light((0.0, 8.0, 4.0), (1, 1, 1), 200.0)
    tables = b.build()
    statics = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.5, 8.0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=45.0)
    r = render(
        tables, cam, make_whitted_integrator(tables, statics, 4), 48, 48, 8
    )
    assert r.n_rejected == 0
    assert np.isfinite(r.image).all()
    # mirror sphere reflects floor/sky -> nonuniform; glass transmits
    assert r.image.std() > 0.05


def test_render_deterministic():
    tables, statics, cam = _cornell()
    integ = make_path_integrator(tables, statics, 2, nee=True)
    r1 = render(tables, cam, integ, W, H, 4, seed=9)
    r2 = render(tables, cam, integ, W, H, 4, seed=9)
    np.testing.assert_array_equal(r1.image, r2.image)


def test_render_chunked_equals_unchunked():
    """spp chunking never changes the image (counter-based RNG)."""
    tables, statics, cam = _cornell()
    integ = make_path_integrator(tables, statics, 2, nee=True)
    r1 = render(tables, cam, integ, W, H, 6, seed=4)
    r2 = render(tables, cam, integ, W, H, 6, seed=4, spp_chunk=2)
    np.testing.assert_allclose(r1.image, r2.image, atol=1e-6)


def test_render_sharded_equals_single(tmp_path):
    """Pixel-axis sharding over the 8-device CPU mesh is bitwise-stable
    vs. the unsharded render (SURVEY.md §7 multi-host determinism)."""
    tables, statics, cam = _cornell()
    integ = make_path_integrator(tables, statics, 2, nee=True)
    r1 = render(tables, cam, integ, W, H, 2, seed=4)
    mesh = default_mesh()
    assert mesh.size == 8  # conftest forces 8 virtual devices
    r2 = render(
        tables, cam, integ, W, H, 2, seed=4,
        sharding=pixel_sharding(mesh),
    )
    np.testing.assert_allclose(r1.image, r2.image, atol=1e-6)


def test_checkpoint_resume(tmp_path):
    tables, statics, cam = _cornell()
    integ = make_path_integrator(tables, statics, 2, nee=True)
    full = render(tables, cam, integ, W, H, 4, seed=3)
    ckpt = os.path.join(tmp_path, "acc.npz")
    # render half, "crash", resume from checkpoint
    render(
        tables, cam, integ, W, H, 2, seed=3, spp_chunk=1, checkpoint_path=ckpt
    )
    acc = Accumulator.load(ckpt)
    assert acc.spp_done == 2
    resumed = render(
        tables, cam, integ, W, H, 4, seed=3, spp_chunk=1, accumulator=acc
    )
    np.testing.assert_allclose(full.image, resumed.image, atol=1e-6)


def test_nan_rejection_counts():
    """Inject a NaN-producing integrator and check rejection semantics
    (Src/renderer.cpp:56-73: sample dropped, still divided by full spp)."""
    tables, statics, cam = _cornell()

    def bad_integrator(rays, keys):
        n = rays.o.shape[0]
        out = jnp.ones((n, 3))
        # first lane NaN, second negative
        out = out.at[0, 0].set(jnp.nan)
        out = out.at[1, 1].set(-1.0)
        return out

    r = render(tables, cam, bad_integrator, W, H, 2, seed=0)
    assert r.n_rejected == 4  # 2 bad lanes x 2 spp
    np.testing.assert_allclose(r.image.reshape(-1, 3)[0], 0.0)
    np.testing.assert_allclose(r.image.reshape(-1, 3)[2], 1.0)


def test_whitted_split_variance():
    """Bounds the per-spp variance cost of the stochastic one-sample Fresnel
    selection that replaces the reference's deterministic both-branch queue
    split (Src/integrator.h:355-381; PARITY.md "Whitted split").

    Measured here: per-pixel std across 6 independent seeds at 16 spp on the
    mirror+glass scene. Recorded values (virtual CPU, round 2): mean relative
    std = 0.040 over the full frame, 0.223 over the glass-sphere region (the
    stochastic lobe choice is the dominant noise there; a deterministic split
    would push it toward the frame mean). The asserted ceilings leave ~50%
    headroom, so a regression that (say) drops the Fresnel weighting or
    double-counts a branch trips the gate.
    """
    b = SceneBuilder()
    floor = np.asarray(
        [
            [[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
            [[10, 0, -10], [10, 0, 10], [-10, 0, 10]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=b.add_lambert((0.8, 0.2, 0.2)))
    b.add_sphere((-1.5, 1.0, 0.0), 1.0, material=b.add_mirror())
    b.add_sphere((1.5, 1.0, 0.0), 1.0, material=b.add_glass())
    b.add_point_light((0.0, 8.0, 4.0), (1, 1, 1), 200.0)
    tables = b.build()
    statics = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.5, 8.0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=45.0)
    integ = make_whitted_integrator(tables, statics, 4)
    imgs = np.stack([
        np.asarray(render(tables, cam, integ, 48, 48, 16, seed=s).image)
        for s in range(6)
    ])
    std = imgs.std(axis=0).mean(axis=-1)          # (H, W)
    mean = np.maximum(imgs.mean(axis=(0, 3)), 1e-3)
    rel = std / mean
    # glass sphere occupies the right-center of the frame
    glass = rel[16:36, 28:46]
    assert rel.mean() < 0.08, rel.mean()
    assert glass.mean() < 0.33, glass.mean()


def test_render_stats_counters():
    """with_stats collects per-bounce counters (SURVEY.md §5) without
    changing the image, and the counters are internally consistent."""
    tables, statics, cam = _cornell()
    integ_s = make_path_integrator(tables, statics, 3, nee=True, with_stats=True)
    integ_p = make_path_integrator(tables, statics, 3, nee=True)
    r_s = render(tables, cam, integ_s, W, H, 4, seed=0)
    r_p = render(tables, cam, integ_p, W, H, 4, seed=0)
    np.testing.assert_array_equal(r_s.image, r_p.image)
    assert r_p.stats is None
    st = r_s.stats
    assert set(st) == {"rays", "shadow_rays", "rr_killed", "emitter_hits",
                       "active_out"}
    # every wavefront lane is a primary ray at depth 0
    assert int(st["rays"][0]) == W * H * 4
    # lanes entering bounce d+1 = lanes alive leaving bounce d
    np.testing.assert_array_equal(st["rays"][1:], st["active_out"][:-1])
    # survivors can't exceed entrants
    assert (st["active_out"] <= st["rays"]).all()
    assert r_s.total_rays == int(st["rays"].sum() + st["shadow_rays"].sum())


def test_many_lights_one_sample_nee():
    """nee_mode="one" (uniform light pick, O(1) shadow sweeps per bounce)
    estimates the same integral as the reference's all-lights loop on a
    many-light scene (round-1 VERDICT weak item 7: no many-light coverage)."""
    b = SceneBuilder()
    floor = np.asarray(
        [
            [[-4, 0, -4], [4, 0, -4], [-4, 0, 4]],
            [[4, 0, -4], [4, 0, 4], [-4, 0, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=b.add_lambert((0.7, 0.7, 0.7)))
    # 8 small quad lights in a ring overhead
    for i in range(8):
        a = 2 * np.pi * i / 8
        cx, cz = 2.5 * np.cos(a), 2.5 * np.sin(a)
        b.add_quad_light(
            (cx + 0.3, 3.0, cz + 0.3), (cx - 0.3, 3.0, cz + 0.3),
            (cx + 0.3, 3.0, cz - 0.3), (4.0, 3.5, 3.0),
        )
    tables = b.build()
    statics = scene_statics(tables)
    assert statics["n_area_lights"] == 8
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 2.0, 8.0, 1)
    cam = PinholeCamera.make(1.0, c2w=c2w, fov_deg=40.0)
    r_all = render(
        tables, cam,
        make_path_integrator(tables, statics, 2, nee=True), 24, 24, 16, seed=1,
    )
    r_one = render(
        tables, cam,
        make_path_integrator(tables, statics, 2, nee=True, nee_mode="one"),
        24, 24, 128, seed=2,
    )
    np.testing.assert_allclose(
        r_one.image.mean(), r_all.image.mean(), rtol=0.05
    )
    # stats reflect the single shadow ray per vertex
    r_st = render(
        tables, cam,
        make_path_integrator(tables, statics, 2, nee=True, nee_mode="one",
                             with_stats=True),
        24, 24, 2, seed=3,
    )
    assert int(r_st.stats["shadow_rays"][0]) <= 24 * 24 * 2


def test_pixel_order_morton_image_identical():
    """Z-order lane traversal (renderer.pixel_grid(order="morton")) must
    produce the bitwise-identical image to raster order: per-pixel RNG
    streams are functions of the PIXEL ID, and assembly un-permutes."""
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(16 / 12, **cornell_camera())
    integ = make_path_integrator(tables, statics, 2, nee=True)
    imgs = []
    for order in ("raster", "morton"):
        r = WavefrontRenderer(
            tables, cam, integ, 16, 12, seed=0, pixel_order=order
        )
        imgs.append(r.render(2).image)
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_checkpoint_resume_across_pixel_orders(tmp_path):
    """A checkpoint written under one lane traversal (raster) resumed by a
    renderer using another (morton) must remap the stored sums instead of
    accumulating mixed orders (code-review round-2 finding: the auto-morton
    threshold change would have silently corrupted pre-existing
    checkpoints)."""
    import os

    from xraytracer.camera import PinholeCamera
    from xraytracer.renderer import Accumulator, WavefrontRenderer
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    w, h = 32, 24
    camera = PinholeCamera.make(w / h, **cornell_camera())

    def renderer(order):
        integ = make_path_integrator(tables, statics, 2, nee=True)
        return WavefrontRenderer(tables, camera, integ, w, h, seed=5,
                                 pixel_order=order)

    ckpt = os.path.join(tmp_path, "acc.npz")
    renderer("raster").render(2, checkpoint_path=ckpt)
    resumed = renderer("morton").render(
        4, accumulator=Accumulator.load(ckpt)
    )
    full = renderer("raster").render(4)
    np.testing.assert_array_equal(resumed.image, full.image)


def test_sorted_wavefront_bitwise_identical():
    """Bounce-ray coherence sorting (geometry/raysort.py) is pure lane
    scheduling: every per-lane draw travels with its RNG key and radiance
    is scattered back to the original lane order, so images are BITWISE
    equal with sorting forced on vs. off — unrolled and fori_loop depths,
    with and without NEE."""
    b, camk = _sphere_mesh_scene()
    tables = b.build()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **camk)
    for depth, nee in ((3, True), (9, False)):
        imgs = []
        for sort in (False, True):
            integ = make_path_integrator(
                tables, statics, max_depth=depth, nee=nee,
                cosine_sampling=True, sort_rays=sort,
            )
            imgs.append(render(tables, cam, integ, W, H, 2, seed=3).image)
        np.testing.assert_array_equal(imgs[0], imgs[1])


def _sphere_mesh_scene():
    from xraytracer.math import from_rows

    b = SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 17, 16, material=white)
    floor = np.asarray(
        [[[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
         [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]]], np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.6, 4.0, 1)
    return b, dict(c2w=c2w, fov_deg=45.0)


def test_sorted_wavefront_stats_match():
    """with_stats counters are permutation-invariant sums."""
    b, camk = _sphere_mesh_scene()
    tables = b.build()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **camk)
    outs = []
    for sort in (False, True):
        integ = make_path_integrator(
            tables, statics, max_depth=3, nee=True, with_stats=True,
            sort_rays=sort,
        )
        r = render(tables, cam, integ, W, H, 2, seed=3)
        outs.append(r.stats)
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
