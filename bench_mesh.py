"""Mesh-scale study: where does the brute-force sweep stop being fast?

The reference has no BVH (``Scene::build()`` is an empty placeholder,
reference: Src/scene.h:22-24) and sweeps every triangle per ray
(Src/primitive.cpp:83-116); its largest test mesh is sphere32.obj (1,921
faces). This harness measures GI rays/s on procedural lat-long sphere
meshes of increasing size (the SphereMesh::Triangulate analogue,
Src/primitive.cpp:170-205) so the brute-force cliff is a recorded number
rather than a guess.

Usage: python bench_mesh.py [--sizes 2k,13k,51k] [--spp 8]
Prints one JSON line per size.
"""

import argparse
import json
import time

SIZES = {
    "2k": (33, 30),      # ~1.9k tris — the sphere32.obj scale
    "13k": (82, 80),     # ~13k
    "51k": (161, 160),   # ~51k — well past anything the reference ships
    "205k": (321, 320),  # ~205k — 100x the reference's largest mesh
    "1m": (709, 708),    # ~1M
}


def build_scene(n_theta, n_phi):
    import numpy as np

    from xraytracer.math import from_rows
    from xraytracer.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, n_theta, n_phi, material=white)
    # floor quad below the sphere
    floor = np.asarray(
        [
            [[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
            [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light(
        (-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
        (10.0, 10.0, 10.0),
    )
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 0.6, 4.0, 1,
    )
    return b, dict(c2w=c2w, fov_deg=45.0)


def bench_one(n_theta, n_phi, spp, w=256, h=192):
    import numpy as np

    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics

    b, camk = build_scene(n_theta, n_phi)
    tables = b.build()
    n_tris = int(np.sum(np.asarray(tables.tri_obj) >= 0))
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **camk)
    integrate = make_path_integrator(
        tables, statics, max_depth=3, nee=True, cosine_sampling=True,
    )
    renderer = WavefrontRenderer(tables, camera, integrate, w, h, seed=0)
    t0 = time.perf_counter()
    renderer.render(1)
    compile_s = time.perf_counter() - t0
    best = max(renderer.render(spp).samples_per_sec for _ in range(3))
    return dict(n_tris=n_tris, rays_per_s=best, compile_s=compile_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2k,13k,51k,205k")
    ap.add_argument("--spp", type=int, default=8)
    args = ap.parse_args()

    from xraytracer.compile_cache import enable_compile_cache

    enable_compile_cache()

    for key in args.sizes.split(","):
        n_theta, n_phi = SIZES[key.strip()]
        r = bench_one(n_theta, n_phi, args.spp)
        print(json.dumps({"size": key, **r}), flush=True)


if __name__ == "__main__":
    main()
