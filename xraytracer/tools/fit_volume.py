"""Inverse VOLUME rendering demo: recover a 16^3 density blob from target
renders by gradient descent.

The volume counterpart of ``fit_scene``. Density gradients are reverse
mode through the bounded-trip tracking loops
(``make_volume_integrator(differentiable=True, score_terms=True)``, the
score-corrected estimator that
tests/test_diff_volume.py::test_density_descent_recovers_blob gates), with
the TWO-SAMPLE product loss E[(a-t)(b-t)] over independent renders a and b,
which removes the Var(img) term a plain L2 minimizes by collapsing density.
Multi-view: every step renders each camera ``pairs`` times and sums the
gradients; Adam under a cosine LR schedule, density parameterized through a
sigmoid.

No reference counterpart (the reference is a pure forward renderer);
capability extension per SURVEY.md §7 step 9.

Usage:
    python -m xraytracer.tools.fit_volume --steps 600 -o fit_vol.npz
"""

import argparse
import json
from types import SimpleNamespace

import numpy as np

RES = 16


def _blob_target(res=RES):
    tgt = np.full((res, res, res), 0.25, np.float32)
    c0, c1 = res // 4, 3 * res // 4
    tgt[c0:c1, c0:c1, c0:c1] = 0.85
    return tgt


def make_problem(width=96, height=72, lr=0.1, steps=600, max_depth=6,
                 pairs=2, target_pairs=64, seed=0, res=RES, max_steps=None):
    """The fit's pieces: ``loss(z, it)`` (the two-sample product loss of
    step ``it``, averaged over views and pairs, ``z`` the pre-sigmoid
    density), the jitted Adam ``step(z, opt_state, it) -> (loss, z,
    opt_state)``, the start ``z0`` with ``opt_state0``, and the target
    grid."""
    import jax
    import jax.numpy as jnp
    import optax

    from ..camera import PinholeCamera
    from ..integrators import make_volume_integrator
    from ..math import from_rows
    from ..renderer import CAMERA_SITE, pixel_grid
    from ..sampling import path_keys, uniform2
    from ..scene.builder import scene_statics
    from ..scene.presets import build_volume_scene

    # majorants baked from a ones grid bound any density in [0, 1]
    # (the documented score-terms caveat)
    # OPTICALLY THIN coefficients: at the wdas-scale extent (~330 units
    # across), sigma_t = 0.10 gives tau ~ 15 — light never reaches the
    # interior, interior-voxel gradients vanish, and descent stalls.
    # sigma_t = 0.005 puts the blob at tau ~ 0.8: every voxel is
    # observable from every view (tomography regime).
    tables = build_volume_scene(
        res=(res, res, res), density=np.ones((res, res, res), np.float32),
        absorption=(0.001, 0.001, 0.001),
        scattering=(0.004, 0.004, 0.004),
        le=120.0, light_center=(0.0, 400.0, 0.0),
    ).build()
    statics = scene_statics(tables)
    tgt_grid = _blob_target(res)

    dist = 540.0
    cams = [
        PinholeCamera.make(width / height, c2w=from_rows(
            1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0,
            0, 40.0, dist, 1), fov_deg=55.0),
        PinholeCamera.make(width / height, c2w=from_rows(
            0, 0, -1.0, 0, 0, 1.0, 0, 0, 1.0, 0, 0, 0,
            dist, 40.0, 0, 1), fov_deg=55.0),
        PinholeCamera.make(width / height, c2w=from_rows(
            1.0, 0, 0, 0, 0, 0, -1.0, 0, 0, 1.0, 0, 0,
            0, dist, 0, 1), fov_deg=55.0),
    ]
    n_views = len(cams)
    cam_stack = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    pixel_ids, pixel_xy = pixel_grid(width, height)
    wh = jnp.asarray([float(width), float(height)])

    def render_one(dens, cam, keys, score):
        integ = make_volume_integrator(
            tables._replace(grid_density=dens), statics, max_depth,
            nee=True, max_steps=max_steps, differentiable=True,
            score_terms=score,
        )
        u = uniform2(keys, CAMERA_SITE)
        return integ(cam.sample_rays((pixel_xy + u) / wh), keys)

    def view_keys(s):
        # (n_views, N) keys: view v draws from stream seed + 1000 * v
        return jnp.stack([
            path_keys(seed + 1000 * v, pixel_ids, s) for v in range(n_views)
        ])

    render_views = jax.vmap(render_one, in_axes=(None, 0, 0, None))

    # targets: mean over many independent renders of the TRUE blob at a
    # sample block above every optimization step's stream
    tgt_render = jax.jit(
        lambda s: render_views(jnp.asarray(tgt_grid), cam_stack,
                               view_keys(s), False)
    )
    target_base = 2 * steps * pairs
    acc = np.zeros((n_views, width * height, 3), np.float32)
    for s in range(target_pairs):
        acc += np.asarray(tgt_render(target_base + s))
    targets = jnp.asarray(acc / target_pairs)

    def loss(z, it):
        dens = jax.nn.sigmoid(z)
        total = 0.0
        for pr in range(pairs):
            s = 2 * (it * pairs + pr)
            a = render_views(dens, cam_stack, view_keys(s), True)
            b = render_views(dens, cam_stack, view_keys(s + 1), True)
            total = total + jnp.mean((a - targets) * (b - targets))
        return total / pairs

    # cosine LR decay must live INSIDE adam (scaling the gradient before
    # adam is a no-op — adam normalizes its input)
    sched = optax.cosine_decay_schedule(lr, steps, alpha=0.05)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))

    @jax.jit
    def step(z, opt_state, it):
        val, g = jax.value_and_grad(loss)(z, it)
        up, opt_state = opt.update(g, opt_state)
        return val, optax.apply_updates(z, up), opt_state

    z0 = jnp.zeros((res, res, res))
    return SimpleNamespace(
        loss=jax.jit(loss), step=step, z0=z0, opt_state0=opt.init(z0),
        target=tgt_grid,
    )


def fit(width=96, height=72, steps=600, lr=0.1, max_depth=6, pairs=2,
        target_pairs=64, seed=0, verbose=False):
    """Run the demo. Returns (history, fitted_density, target_density)."""
    import jax
    import jax.numpy as jnp

    prob = make_problem(
        width=width, height=height, lr=lr, steps=steps, max_depth=max_depth,
        pairs=pairs, target_pairs=target_pairs, seed=seed,
    )
    z, ost = prob.z0, prob.opt_state0
    history = []
    for it in range(steps):
        loss, z, ost = prob.step(z, ost, jnp.int32(it))
        history.append(float(loss))
        if verbose and it % 25 == 0:
            d = np.asarray(jax.nn.sigmoid(z))
            print(json.dumps({
                "step": it, "loss": history[-1],
                "mae": float(np.abs(d - prob.target).mean()),
            }), flush=True)
    return history, np.asarray(jax.nn.sigmoid(z)), prob.target


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=72)
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    hist, fitted, tgt = fit(
        width=args.width, height=args.height, steps=args.steps,
        pairs=args.pairs, lr=args.lr, verbose=args.verbose,
    )
    c0, c1 = RES // 4, 3 * RES // 4
    mae = float(np.abs(fitted - tgt).mean())
    center = float(fitted[c0:c1, c0:c1, c0:c1].mean())
    n_in = (c1 - c0) ** 3
    outer = float(
        (fitted.sum() - fitted[c0:c1, c0:c1, c0:c1].sum())
        / (fitted.size - n_in)
    )
    print(json.dumps({
        "mae": mae, "center": center, "outer": outer,
        "center_target": 0.85, "outer_target": 0.25,
        "final_loss": hist[-1],
    }))
    if args.out:
        np.savez(args.out, fitted=fitted, target=tgt,
                 history=np.asarray(hist))


if __name__ == "__main__":
    main()
