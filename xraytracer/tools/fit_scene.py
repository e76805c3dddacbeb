"""Inverse rendering demo: recover material albedos and lamp emission of
the Cornell box from target renders by gradient descent.

No reference counterpart (the reference is a pure forward renderer,
SURVEY.md §2); this exercises the differentiable surface path (diff.py)
end to end — the capability BASELINE.md's north star prices with the
forward+backward throughput metric (bench.py ``fwd_bwd_rays_per_s``).

Estimator note: the path integrator samples directions from the COSINE
hemisphere and lights uniformly — neither distribution depends on albedo
or Le, so the detached-sampling gradient is an unbiased estimator of the
gradient of the expected image and plain stochastic descent converges.
Density-grid descent needs two more ingredients (round 4): the
score-corrected tracking estimator
(``make_volume_integrator(differentiable=True, score_terms=True)`` — the
tracking decisions' probabilities depend on density, and dropping their
score term makes descent diverge) and a TWO-SAMPLE product loss
(E[(a-t)(b-t)] over independent renders, removing the Var(img) term a
plain L2 on a noisy render minimizes by collapsing density to zero).
Demonstrated end to end by
tests/test_diff_volume.py::test_density_descent_recovers_blob and
tools/fit_volume.py.

Usage:
    python -m xraytracer.tools.fit_scene --steps 80 -o fit.npz
"""

import argparse
from types import SimpleNamespace

import numpy as np


def make_problem(
    width=32, height=24, lr=0.1, max_depth=2, spp=2, target_spp=16,
    target_base=1 << 20, seed=0,
):
    """The fit's pieces: ``loss(params, s)``, the jitted Adam
    ``step(params, opt_state, s) -> (loss, params, opt_state)``, the blind
    start ``params0`` with its ``opt_state0``, and ``true_params``.

    The target is rendered once, well averaged, from the TRUE scene at the
    sample block starting at ``target_base``, which must lie above every
    optimization step's stream (step ``s`` uses indices s*spp .. s*spp +
    spp - 1) — sharing a stream would let the optimizer fit the target's
    residual noise."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    from ..camera import PinholeCamera
    from ..diff import make_radiance_fn
    from ..renderer import pixel_grid
    from ..scene.builder import scene_statics
    from ..scene.presets import build_cornell_box, cornell_camera

    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camera = PinholeCamera.make(width / height, **cornell_camera())
    pixel_ids, pixel_xy = pixel_grid(width, height)
    radiance = make_radiance_fn(
        tables, statics, camera, width, height, max_depth=max_depth,
        seed=seed,
    )

    true_params = {
        "mat_albedo": np.asarray(tables.mat_albedo),
        "al_le": np.asarray(tables.al_le),
    }

    def render_avg(params, sample_base, count):
        def body(k, acc):
            return acc + radiance(params, pixel_ids, pixel_xy,
                                  sample_base + k)

        out = lax.fori_loop(
            0, count, body, jnp.zeros((pixel_ids.shape[0], 3))
        )
        return out / count

    img_t = jax.jit(render_avg, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in true_params.items()}, target_base,
        target_spp,
    )

    opt = optax.adam(lr)

    def loss(params, s):
        img = render_avg(params, s * spp, spp)
        return jnp.mean((img - img_t) ** 2)

    @jax.jit
    def step(params, opt_state, s):
        val, grad = jax.value_and_grad(loss)(params, s)
        upd, opt_state = opt.update(grad, opt_state)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        # physical ranges: albedo in [0, 1], emission nonnegative
        params["mat_albedo"] = jnp.clip(params["mat_albedo"], 0.0, 1.0)
        params["al_le"] = jnp.maximum(params["al_le"], 0.0)
        return val, params, opt_state

    # blind start: every material mid-gray, lamp dim
    params0 = {
        "mat_albedo": jnp.full_like(tables.mat_albedo, 0.5),
        "al_le": jnp.full_like(tables.al_le, 5.0),
    }
    return SimpleNamespace(
        loss=jax.jit(loss), step=step, params0=params0,
        opt_state0=opt.init(params0), true_params=true_params,
    )


def fit(
    width=32, height=24, steps=300, lr=0.1, max_depth=2, spp=2,
    target_spp=16, seed=0, verbose=False,
):
    """Run the demo. Returns (loss_history, fitted_params, true_params)."""
    import jax.numpy as jnp

    prob = make_problem(
        width=width, height=height, lr=lr, max_depth=max_depth, spp=spp,
        target_spp=target_spp, target_base=steps * spp, seed=seed,
    )
    true_params = prob.true_params
    params, opt_state = prob.params0, prob.opt_state0
    history = []
    for s in range(steps):
        val, params, opt_state = prob.step(params, opt_state, jnp.int32(s))
        history.append(float(val))
        if verbose and (s % 10 == 0 or s == steps - 1):
            alb_err = float(np.abs(
                np.asarray(params["mat_albedo"]) - true_params["mat_albedo"]
            ).mean())
            le_err = float(np.abs(
                np.asarray(params["al_le"]) - true_params["al_le"]
            ).mean())
            print(f"step {s:3d}  loss {val:.5f}  albedo MAE {alb_err:.4f}"
                  f"  Le MAE {le_err:.3f}", flush=True)
    fitted = {k: np.asarray(v) for k, v in params.items()}
    return history, fitted, true_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("-o", "--out", default=None,
                   help="save fitted + true params to this .npz")
    a = p.parse_args(argv)
    hist, fitted, true_params = fit(
        width=a.width, height=a.height, steps=a.steps, lr=a.lr, spp=a.spp,
        verbose=True,
    )
    alb_err = np.abs(fitted["mat_albedo"] - true_params["mat_albedo"]).mean()
    print(f"loss {np.mean(hist[:5]):.5f} -> {np.mean(hist[-5:]):.5f}, "
          f"albedo MAE {alb_err:.4f}")
    if a.out:
        np.savez(a.out, loss=np.asarray(hist),
                 **{f"fit_{k}": v for k, v in fitted.items()},
                 **{f"true_{k}": v for k, v in true_params.items()})
        print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
