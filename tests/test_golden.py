"""Golden-image regression gate (SURVEY.md §4: the reference's informal
golden JPGs become a checked-in reproducible array compared bitwise-ish).

The golden was generated on the CPU backend at the pinned seed; the RNG is
a pure counter-based function, so any change to sampling order, pdf
conventions, or integrator logic shifts the image and fails here."""

import os

import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.integrators import make_path_integrator
from xraytracer.renderer import render
from xraytracer.scene.builder import scene_statics
from xraytracer.scene.presets import build_cornell_box, cornell_camera

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "cornell_gi_32x24_8spp_seed0.npy"
)


def cornell_gi_render():
    W, H = 32, 24
    tables = build_cornell_box().build()
    st = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **cornell_camera())
    return render(
        tables, cam, make_path_integrator(tables, st, 3, nee=True),
        W, H, 8, seed=0,
    )


def test_cornell_gi_matches_golden():
    r = cornell_gi_render()
    expect = np.load(GOLDEN)
    np.testing.assert_allclose(r.image, expect, rtol=1e-5, atol=1e-6)


def round_bf16(a):
    """f32 -> nearest bf16 -> f32."""
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float32
    )


VOLUME_GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "cloud_nee_24x18_4spp_seed0.npy"
)


def cloud_nee_render():
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.math import from_rows
    from xraytracer.scene.presets import build_volume_scene, procedural_cloud

    W, H = 24, 18
    # the golden was rendered from the bf16-rounded field; keep the input
    # identical so the image stays bitwise comparable
    density = round_bf16(procedural_cloud(res=(24, 20, 16), seed=3))
    tables = build_volume_scene(
        density=density, absorption=(0.02, 0.02, 0.02),
        scattering=(0.06, 0.05, 0.04), le=30.0,
    ).build()
    st = scene_statics(tables)
    c2w = from_rows(
        1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1
    )
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0)
    from xraytracer.integrators import make_volume_integrator

    integ = make_volume_integrator(tables, st, 8, nee=True, max_steps=96)
    return render(tables, cam, integ, W, H, 4, seed=0)


def test_cloud_nee_matches_golden():
    """Heterogeneous VolumePathTracingNEE regression gate: supergrid DDA,
    delta tracking, ratio-tracked shadow transmittance, sphere-light NEE —
    any change to the volume sampling order or pdfs shifts this image."""
    r = cloud_nee_render()
    expect = np.load(VOLUME_GOLDEN)
    assert r.n_rejected == 0
    np.testing.assert_allclose(r.image, expect, rtol=1e-5, atol=1e-7)


if __name__ == "__main__":  # regenerate goldens (run on the CPU backend)
    r = cloud_nee_render()
    np.save(VOLUME_GOLDEN, r.image)
    print("wrote", VOLUME_GOLDEN, r.image.mean())
