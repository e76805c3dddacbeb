"""Many-light scaling: per-sample cost vs light count.

The reference picks lights uniformly from a list it never grows past 2
(Src/scene.cpp:182-188; largest shipped scene has 1 quad light). This
harness renders a room whose ceiling carries an n x n grid of quad lights
of skewed powers and measures GI rays/s with ``nee_mode="power"`` (single
power-CDF-picked light per vertex -> ONE shadow sweep per bounce
regardless of light count) against the 1-light baseline — demonstrating
per-sample cost O(1) in light count where the reference's all-lights NEE
is O(n_lights).

Usage: python bench_lights.py [--spp 32]
Prints one JSON line per light count.
"""

import argparse
import json


def build_room(n_side):
    import numpy as np

    from xraytracer.math import from_rows
    from xraytracer.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for v0, v1, v2, v3 in (
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
        ((0, 0, 0), (0, 0, 559), (0, 548, 559), (0, 548, 0)),
        ((556, 0, 0), (556, 0, 559), (556, 548, 559), (556, 548, 0)),
    ):
        # wound so geometric normals face the room interior (NEE's cos
        # clamps against ng)
        quads.append(np.asarray([[v0, v2, v1], [v0, v3, v2]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    rng = np.random.default_rng(11)
    pitch = 480.0 / n_side
    size = min(30.0, 0.5 * pitch)
    total_power = 1200.0            # shared budget: comparable images
    for i in range(n_side):
        for j in range(n_side):
            x0 = 40.0 + i * pitch
            z0 = 40.0 + j * pitch
            power = float(rng.uniform(0.1, 2.0))
            le = power * total_power / (n_side * n_side * size * size)
            b.add_quad_light(
                (x0, 547.0, z0), (x0 + size, 547.0, z0),
                (x0, 547.0, z0 + size), (le,) * 3,
            )
    c2w = from_rows(
        -1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, -1.0, 0,
        278.0, 273.0, -600.0, 1,
    )
    return b, dict(c2w=c2w, fov_deg=38.0)


def bench_one(n_side, spp, w=512, h=384):
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics

    b, camk = build_room(n_side)
    tables = b.build()
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **camk)
    integrate = make_path_integrator(
        tables, statics, max_depth=3, nee=True, cosine_sampling=True,
        nee_mode="power",
    )
    renderer = WavefrontRenderer(tables, camera, integrate, w, h, seed=0)
    renderer.render(2)
    best = max(renderer.render(spp).samples_per_sec for _ in range(3))
    return dict(n_lights=n_side * n_side, rays_per_s=best)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--sides", default="1,4,8")
    args = ap.parse_args()

    from xraytracer.compile_cache import enable_compile_cache

    enable_compile_cache()

    for s in args.sides.split(","):
        r = bench_one(int(s), args.spp)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
