"""Differentiable rendering: gradients of radiance w.r.t. scene parameters.

No counterpart exists in the reference (pure forward renderer); this is the
capability extension called for by BASELINE.md's north star (forward +
backward rays/s) and SURVEY.md §7 step 9.

Design: the surface path integrators are pure ``fori_loop`` programs over
jnp arrays, so ``jax.grad`` w.r.t. any ``SceneTables`` leaf (albedo, Le,
density) works directly. Discrete sampling decisions (RR kill, lobe choice,
light pick) enter only through boolean masks — autodiff naturally treats
them as detached, differentiating only the continuous integrand factors
(the detached-sampling estimator; SURVEY.md §7 "hard parts"). The volume
integrators' default ``lax.while_loop`` tracking loops are not reverse-mode
differentiable; ``make_volume_integrator(differentiable=True)`` switches
them to ``max_steps``-bounded ``fori_loop`` variants, making
sigma_a/sigma_s/Le/grid-density gradients available (tested in
tests/test_diff_volume.py).

Every pipeline here runs the default ``intersect_triangles_mm`` sweep,
whose outputs also differentiate w.r.t. vertex positions.
"""

import jax
import jax.numpy as jnp

from .integrators import make_path_integrator
from .renderer import CAMERA_SITE
from .sampling import path_keys, uniform2


def make_radiance_fn(
    tables, statics, camera, width, height, max_depth=3, nee=True,
    cosine_sampling=True, seed=0, nee_mode="all",
):
    """Returns ``radiance(params, pixel_ids, pixel_xy, sample_idx) -> (N,3)``
    where ``params`` is a dict of SceneTables overrides (e.g.
    ``{"mat_albedo": ..., "al_le": ...}``) — the differentiable inputs."""
    wh = jnp.asarray([float(width), float(height)])
    pick_w = None
    if nee_mode == "power":
        # bake the pick distribution from the CONCRETE base tables — the
        # traced (overridden) tables cannot weigh and would silently fall
        # back to uniform picking (the pick is a detached sampling choice
        # either way)
        from .lights import light_power_weights

        pick_w = light_power_weights(tables)

    def radiance(params, pixel_ids, pixel_xy, sample_idx):
        from .scene.tables import rejoin_appearance

        # re-derive the denormalized per-triangle appearance columns from
        # the overridden relational params so gradients reach them
        scene = rejoin_appearance(tables._replace(**params))
        integrate = make_path_integrator(
            scene, statics, max_depth, nee=nee,
            cosine_sampling=cosine_sampling,
            nee_mode=nee_mode, pick_weights=pick_w,
        )
        keys = path_keys(seed, pixel_ids, sample_idx)
        u = uniform2(keys, CAMERA_SITE)
        rays = camera.sample_rays((pixel_xy + u) / wh)
        return integrate(rays, keys)

    return radiance


def make_loss_fn(radiance_fn):
    """L2 image loss against a target; mean over lanes and channels."""

    def loss(params, pixel_ids, pixel_xy, target, sample_idx):
        img = radiance_fn(params, pixel_ids, pixel_xy, sample_idx)
        return jnp.mean((img - target) ** 2)

    return loss


def make_train_step(radiance_fn, lr=0.05):
    """One SGD step on the differentiable scene params. Under a sharded jit
    the pixel-axis inputs are sharded and XLA inserts the cross-device
    ``psum`` for the (replicated) parameter gradients automatically."""
    loss = make_loss_fn(radiance_fn)
    grad_fn = jax.value_and_grad(loss)

    def step(params, pixel_ids, pixel_xy, target, sample_idx):
        val, g = grad_fn(params, pixel_ids, pixel_xy, target, sample_idx)
        new = {k: v - lr * g[k] for k, v in params.items()}
        return val, new, g

    return step
