"""Forward+backward cost decomposition.

Each variant times value_and_grad of the L2 image loss on the GI Cornell
differentiable pipeline (diff.py, 780x585) with one knob turned, on the
local accelerator:

  fwd         — forward radiance only (no grad)
  base        — value_and_grad w.r.t. mat_albedo (the bench metric)
  vjp_fwd     — jax.vjp forward half only (residual-saving cost: the gap
                between this and `fwd` is what materializing the tape
                costs; the gap between `base` and this is the transpose)
  nonee       — nee=False (drops the shadow sweep + light epilogue)
  depth1      — max_depth=1
  remat       — jax.checkpoint around the whole radiance fn (recompute
                instead of materialize; tells if the tape is HBM-bound)
  allparams   — grads w.r.t. mat_albedo AND al_le

Usage: python bench_fwdbwd.py [variant ...]
Prints one JSON line per variant: {"variant", "rays_per_s"}.
"""

import json
import sys
import time


def build(variant):
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
    kw = dict(max_depth=3, cosine_sampling=True)
    if variant == "nonee":
        kw["nee"] = False
    if variant == "depth1":
        kw["max_depth"] = 1
    radiance = make_radiance_fn(tables, statics, camera, w, h, **kw)
    if variant == "remat":
        radiance = jax.checkpoint(radiance)
    pixel_ids, pixel_xy = pixel_grid(w, h)
    target = jnp.zeros((w * h, 3))
    params = {"mat_albedo": tables.mat_albedo}
    if variant == "allparams":
        params["al_le"] = tables.al_le
    loss = make_loss_fn(radiance)

    if variant == "fwd":
        fn = jax.jit(
            lambda p, s: jnp.sum(radiance(p, pixel_ids, pixel_xy, s))
        )

        def run(s):
            return fn(params, s)
    elif variant == "vjp_fwd":
        # forward half of reverse-mode only: linearize saves the SAME
        # residuals as value_and_grad but never runs the transpose
        fn = jax.jit(
            lambda p, s: jax.vjp(
                lambda q: loss(q, pixel_ids, pixel_xy, target, s), p
            )[0]
        )

        def run(s):
            return fn(params, s)
    else:
        grad_fn = jax.jit(jax.value_and_grad(loss))

        def run(s):
            v, g = grad_fn(params, pixel_ids, pixel_xy, target, s)
            return g["mat_albedo"]

    return run, w * h


def main(argv):
    import jax

    from xraytracer.compile_cache import enable_compile_cache

    enable_compile_cache()

    variants = argv or ["fwd", "base", "vjp_fwd", "nonee", "depth1",
                        "remat", "allparams"]
    for v in variants:
        run, n_rays = build(v)
        jax.block_until_ready(run(0))                      # compile
        n_steps = 8
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            out = None
            for s in range(1, 1 + n_steps):
                out = run(s)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            best = max(best, n_rays * n_steps / dt)
        print(json.dumps({"variant": v, "rays_per_s": round(best)}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
