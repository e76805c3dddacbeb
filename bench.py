"""Benchmark: GI Cornell box rays/s on the local GPU, plus secondary jobs.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}.
``device`` names the platform, device kind, device count and the card's
name and power limit (nvidia-smi). With no GPU the script exits non-zero
and prints no result; a failing secondary metric also exits non-zero.

``extra`` carries the secondary metrics:
  * fwd_bwd_rays_per_s — primary rays/s for reverse-mode value_and_grad of
    the L2 loss on the GI Cornell pipeline (diff.py);
  * vpt_rays_per_s — homogeneous VolumePathTracing preset (256x256 depth 10);
  * het_tracking_ms — one heterogeneous delta-tracking wavefront
    (65k lanes, bounded masked loop) on the procedural cloud;
  * het_nee_ms_per_spp — the reference nee workload (cloud + sphere light,
    VolumePathTracingNEE depth 32) at 256x256;
  * mesh_gi_51k_rays_per_s — GI depth-3 NEE on a 51k-triangle sphere mesh
    (bench_mesh.py's 51k point).
Set XRT_BENCH_FAST=1 to skip the extras (primary metric only).

Every timed metric carries {value, spp, best_of, spread_pct}.
"""

import json
import os
import sys
import time


def _bench_gi_forward():
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_path_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    w, h = 780, 585
    spp = 256
    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **cornell_camera())
    integrate = make_path_integrator(
        tables, statics, max_depth=3, nee=True, cosine_sampling=True
    )
    # one compiled pipeline; the warmup call pays compilation, timed calls
    # reuse it
    renderer = WavefrontRenderer(tables, camera, integrate, w, h, seed=0)
    renderer.render(2)
    runs = [renderer.render(spp).samples_per_sec for _ in range(3)]
    return {
        "value": max(runs),
        "spp": spp,
        "best_of": len(runs),
        "spread_pct": round(100.0 * (max(runs) - min(runs)) / max(runs), 2),
    }


def _bench_gi_fwd_bwd():
    """rays/s through value_and_grad of the L2 image loss (diff.py pipeline:
    XLA matmul sweep, rejoined appearance)."""
    import jax
    import jax.numpy as jnp

    from xraytracer.camera import PinholeCamera
    from xraytracer.diff import make_loss_fn, make_radiance_fn
    from xraytracer.renderer import pixel_grid
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    w, h = 780, 585
    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **cornell_camera())
    radiance = make_radiance_fn(
        tables, statics, camera, w, h, max_depth=3, cosine_sampling=True
    )
    pixel_ids, pixel_xy = pixel_grid(w, h)
    target = jnp.zeros((w * h, 3))
    params = {"mat_albedo": tables.mat_albedo}

    def time_steps(fn):
        val, g = fn(params, pixel_ids, pixel_xy, target, 0)   # compile
        jax.block_until_ready(g["mat_albedo"])
        n_steps = 8
        t0 = time.perf_counter()
        for s in range(1, 1 + n_steps):
            val, g = fn(params, pixel_ids, pixel_xy, target, s)
        jax.block_until_ready(g["mat_albedo"])
        return w * h * n_steps / (time.perf_counter() - t0)

    return {
        "value": time_steps(jax.jit(jax.value_and_grad(make_loss_fn(radiance)))),
        "method": "autodiff",
    }


def _bench_vpt():
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import preset_vpt

    tables, cam_kwargs, cfg = preset_vpt()
    w = h = 256
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **cam_kwargs)
    integrate = make_volume_integrator(tables, statics, 10, nee=False)
    renderer = WavefrontRenderer(tables, camera, integrate, w, h, seed=0)
    renderer.render(1)
    # best of 7 512-spp calls; the trimmed middle-5 spread records the
    # call-to-call noise
    runs = sorted(renderer.render(512).samples_per_sec for _ in range(7))
    mid = runs[1:-1]
    return {
        "value": runs[-1],
        "spp": 512,
        "best_of": len(runs),
        "spread_pct": round(100.0 * (mid[-1] - mid[0]) / mid[-1], 2),
        "spread_kind": "middle5_of_7",
    }


def _bench_het_tracking():
    """One bounded-loop delta-tracking wavefront on the procedural cloud:
    65k lanes through sample_medium (the volume-path hot loop)."""
    import jax
    import jax.numpy as jnp

    from xraytracer.geometry import Rays
    from xraytracer.media import sample_medium
    from xraytracer.sampling import path_keys
    from xraytracer.scene.presets import build_volume_scene

    tables = build_volume_scene().build()
    n = 65536
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 400.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    rays = Rays(o=o, d=d)
    t0v = jnp.full((n,), 240.0)
    t1v = jnp.full((n,), 560.0)
    tp = jnp.ones((n, 3))

    @jax.jit
    def run(keys):
        ms = sample_medium(
            tables, jnp.zeros((n,), jnp.int32), rays, t0v, t1v, tp, keys, 16,
            max_steps=128, has_heterogeneous=True,
        )
        return ms.weight

    # per-rep key sets hashed OUTSIDE jit (base_key needs a concrete seed);
    # one compile serves every rep
    key_sets = [path_keys(i, jnp.arange(n, dtype=jnp.int32), 0)
                for i in range(6)]
    jax.block_until_ready(run(key_sets[0]))
    reps = 5
    t0 = time.perf_counter()
    for i in range(1, 1 + reps):
        out = run(key_sets[i])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _bench_het_nee():
    from xraytracer.camera import PinholeCamera
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import preset_nee

    tables, cam_kwargs, cfg = preset_nee()
    w = h = 256
    statics = scene_statics(tables)
    camera = PinholeCamera.make(w / h, **cam_kwargs)
    integrate = make_volume_integrator(
        tables, statics, cfg["max_depth"], nee=True
    )
    renderer = WavefrontRenderer(tables, camera, integrate, w, h, seed=0)
    renderer.render(1)
    runs = [renderer.render(8).seconds / 8 * 1e3 for _ in range(2)]
    return {
        "value": min(runs),
        "spp": 8,
        "best_of": len(runs),
        "spread_pct": round(100.0 * (max(runs) - min(runs)) / max(runs), 2),
    }


def _bench_mesh_51k():
    import bench_mesh

    n_theta, n_phi = bench_mesh.SIZES["51k"]
    runs = [bench_mesh.bench_one(n_theta, n_phi, spp=4)["rays_per_s"]
            for _ in range(2)]
    return {
        "value": max(runs),
        "spp": 4,
        "best_of": len(runs),
        "spread_pct": round(100.0 * (max(runs) - min(runs)) / max(runs), 2),
    }


def main():
    from xraytracer.compile_cache import enable_compile_cache
    from xraytracer.device import device_stamp, require_gpu

    device = device_stamp(require_gpu())
    enable_compile_cache()

    gi = _bench_gi_forward()
    rays_per_s = gi.pop("value")
    extra = {"gi_methodology": gi}
    if not os.environ.get("XRT_BENCH_FAST"):
        for name, fn in (
            ("fwd_bwd_rays_per_s", _bench_gi_fwd_bwd),
            ("vpt_rays_per_s", _bench_vpt),
            ("het_tracking_ms", _bench_het_tracking),
            ("het_nee_ms_per_spp", _bench_het_nee),
            ("mesh_gi_51k_rays_per_s", _bench_mesh_51k),
        ):
            extra[name] = fn()

    print(
        json.dumps(
            {
                "metric": "gi_cornell_primary_rays_per_s",
                "value": rays_per_s,
                "unit": "rays/s",
                "device": device,
                "extra": extra,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
