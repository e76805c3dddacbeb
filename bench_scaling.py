"""Device-count scaling harness: GI Cornell rays/s of the pixel-sharded
renderer (NamedSharding over the pixel axis, no collectives) on 1..N local
devices, with the scaling efficiency against one device.

It measures the devices JAX finds and refuses to run when there are fewer
than requested; it never substitutes virtual CPU devices.

Usage: python bench_scaling.py [--devices 1 2 4] [--spp 4]
"""

import argparse
import json


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=384)
    args = p.parse_args()

    import jax

    n_want = max(args.devices)
    devs = jax.local_devices()
    if len(devs) < n_want:
        raise SystemExit(
            f"bench_scaling: {n_want} devices requested, JAX found "
            f"{len(devs)} ({devs[0].platform})"
        )

    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.parallel import make_mesh
    from xraytracer.renderer import WavefrontRenderer, pixel_sharding
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    w, h = args.width, args.height
    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **cornell_camera())
    integrate = make_path_integrator(
        tables, statics, max_depth=3, nee=True, cosine_sampling=True
    )

    rows = []
    base = None
    print(json.dumps({"platform": devs[0].platform,
                      "device_kind": devs[0].device_kind,
                      "device_count": len(devs)}))
    for nd in args.devices:
        mesh = make_mesh(nd)
        r = WavefrontRenderer(
            tables, camera, integrate, w, h, seed=0,
            sharding=pixel_sharding(mesh),
        )
        r.render(1)  # compile
        res = r.render(args.spp)
        rps = res.samples_per_sec
        if base is None:
            base = rps
        eff = rps / (base * nd)
        rows.append(dict(devices=nd, rays_per_s=rps, efficiency=eff))
        print(
            f"devices={nd:2d}  {rps/1e6:8.3f} Mrays/s  "
            f"scaling-efficiency={eff:6.1%}"
        )
    print(json.dumps({"metric": "scaling", "rows": rows}))


if __name__ == "__main__":
    main()
