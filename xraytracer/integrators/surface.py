"""Surface integrators: Normal, Furnace, Direct, Indirect/GI, Whitted.

Wavefront counterpart of the reference's recursive/iterative per-ray
integrators (reference: Src/integrator.h:22-398). Every integrator is a
factory closing over the scene tables and scene statics; the returned
``integrate(rays, keys) -> (N, 3)`` runs the whole wavefront through a
``lax.fori_loop`` over bounce index with per-lane active masks — break
becomes mask-kill, Russian roulette becomes masked kill + throughput boost
(SURVEY.md §7).

RNG site layout: each bounce reserves ``SITES_PER_BOUNCE`` sites; within a
bounce, site 0 is RR, 1 is the BSDF 2-uniform, 2 the BSDF lobe choice, and
16+i the i-th light sample.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import INF, SHADOW_BIAS
from ..geometry import Rays, intersect_scene, occluded
from ..lights import area_light_le, sample_area_light, sample_delta_light
from ..materials import eval_bsdf_direct, sample_bsdf_direct
from ..math import dot, local_to_world, world_to_local
from ..sampling import SITES_PER_BOUNCE, uniform1, uniform2

_SITE_RR = 0
_SITE_BSDF = 1
_SITE_LOBE = 2
_SITE_LIGHT0 = 16


def _obj_light(scene, obj):
    """Object id -> area-light row (-1 = none), the ``hasAreaLight`` check
    (reference: Src/primitive.h:56-58)."""
    return jnp.where(obj >= 0, scene.obj_light[jnp.maximum(obj, 0)], -1)


def make_normal_integrator(scene):
    """Normal visualization 0.5*(ns+1) (reference: Src/integrator.h:22-36).
    Black on miss."""

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays)
        viz = 0.5 * (hit.ns + 1.0)
        return jnp.where(hit.hit[:, None], viz, 0.0)

    return integrate


def make_furnace_integrator(scene, cosine_sampling=False):
    """The reference's latent furnace test (dead code at
    Src/integrator.h:59-66), resurrected live: one BSDF sample, returns
    fr * cos / pdf whose expectation is the albedo — the analytic
    correctness gate for sampler + BSDF plumbing (SURVEY.md §4a)."""

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays)
        wo = world_to_local(-rays.d, hit.dpdu, hit.ns, hit.dpdv)
        u2 = uniform2(keys, _SITE_BSDF)
        ul = uniform1(keys, _SITE_LOBE)
        bs = sample_bsdf_direct(
            hit.mtype, hit.albedo, hit.ior, wo, u2, ul, cosine_sampling
        )
        return jnp.where(hit.hit[:, None], bs.weight, 0.0)

    return integrate


def _nee_area_lights(
    scene, statics, hit, d_in, throughput, keys, site0,
    mis=False, cosine_sampling=False, nee_mode="all", active=None,
    park=None, pick_weights=None,
):
    """Per-vertex NEE over area lights.

    ``nee_mode="all"`` (default) sums over ALL lights like the reference
    (Src/integrator.h:93-109 and 250-269: no light selection, no MIS) —
    compiled cost O(n_lights), fine for reference scenes (<= 2 lights).
    ``nee_mode="one"`` draws a single uniformly-picked light per vertex
    (contribution / pick probability — the volume NEE's strategy,
    Src/integrator.h:586-602) so many-light scenes compile O(1) sweeps per
    bounce; same expectation, higher per-spp variance.
    ``nee_mode="power"`` is "one" with the pick probability proportional to
    each light's emitted power (mean Le x area) via the general
    ``DiscreteDistribution1D`` — same expectation, much lower variance when
    light powers are skewed.

    cos is clamped against the geometric normal and shadow rays start at
    position + 0.01 * ng with range tmax - 0.01, exactly as the reference.
    With ``mis`` each light sample is power-heuristic weighted against the
    BSDF pdf for the same direction (capability beyond the reference).
    """
    from ..materials import bsdf_pdf_direct

    n_lights = statics["n_area_lights"]
    direct = jnp.zeros_like(throughput)
    if nee_mode in ("one", "power") and n_lights > 0:
        from ..lights import pick_uniform_light

        u_pick = uniform1(keys, site0 + 0)
        if nee_mode == "power":
            # power-proportional selection through the general N-bin CDF
            # container (Src/sampler.h:53-97's intended many-light use):
            # bright lights are picked more often, contribution / pmf keeps
            # the estimator unbiased; zero-power lights are never picked.
            # Traced tables (donated pytrees) can't weigh — uniform then.
            from ..lights import light_power_weights
            from ..sampling import DiscreteDistribution1D

            # the pick distribution is a SAMPLING choice, detached from
            # the estimator — differentiable pipelines pass concrete
            # ``pick_weights`` baked from the base tables (traced tables
            # cannot weigh and would silently fall back to uniform)
            if pick_weights is not None:
                w = np.asarray(pick_weights)[:n_lights]
            else:
                try:
                    w = light_power_weights(scene)[:n_lights]
                except Exception:
                    w = None
            if w is not None:
                lidx, pick_prob = DiscreteDistribution1D(w).sample(u_pick)
            else:
                lidx, pick_prob = pick_uniform_light(n_lights, u_pick)
        else:
            lidx, pick_prob = pick_uniform_light(n_lights, u_pick)
        u2 = uniform2(keys, site0 + 1)
        ls = sample_area_light(scene, lidx, hit.position, u2)
        ls = ls._replace(pdf=ls.pdf * pick_prob)
        light_iter = [(lidx, ls)]
    else:
        light_iter = None

    for i in range(n_lights if light_iter is None else 1):
        if light_iter is not None:
            lidx, ls = light_iter[i]
        else:
            lidx = jnp.full(hit.obj.shape, i, jnp.int32)
            u2 = uniform2(keys, site0 + i)
            ls = sample_area_light(scene, lidx, hit.position, u2)
        ok = ls.pdf > 0.0
        cos = jnp.maximum(0.0, dot(hit.ng, ls.wi))
        so = hit.position + hit.ng * SHADOW_BIAS
        sd = ls.wi
        tmax = ls.t_max - SHADOW_BIAS
        if active is not None and park is not None:
            # Park shadow rays whose contribution is already masked to
            # zero (dead / emitter / RR-killed lanes, backfacing or
            # zero-pdf vertices): origin outside the scene and t_max = 0,
            # so they stay out of the coherent sorted rows. Image-bitwise-
            # neutral:
            # ``vis`` is only consumed through (vis & ok) * cos, which is
            # zero for every parked lane.
            live = active & ok & (cos > 0.0)
            park_o, park_d = park
            lm = live[:, None]
            so = jnp.where(lm, so, park_o)
            sd = jnp.where(lm, sd, park_d)
            tmax = jnp.where(live, tmax, 0.0)
        srays = Rays(o=so, d=sd)
        vis = ~occluded(scene, srays, tmax)
        wo_l = world_to_local(-d_in, hit.dpdu, hit.ns, hit.dpdv)
        wi_l = world_to_local(ls.wi, hit.dpdu, hit.ns, hit.dpdv)
        fr = eval_bsdf_direct(hit.mtype, hit.albedo, wo_l, wi_l)
        pdf = jnp.where(ok, ls.pdf, 1.0)
        contrib = (vis & ok)[:, None] * fr * ls.le * (cos / pdf)[:, None]
        if mis:
            p_b = bsdf_pdf_direct(hit.mtype, wo_l, wi_l, cosine_sampling)
            w = ls.pdf ** 2 / jnp.maximum(ls.pdf ** 2 + p_b ** 2, 1e-20)
            contrib = contrib * jnp.where(ok, w, 1.0)[:, None]
        direct = direct + contrib
    return direct


def make_direct_integrator(scene, statics):
    """One-bounce direct lighting (reference: Src/integrator.h:76-120):
    emitter hit -> Le; surface -> NEE over all area lights; miss -> 0.18
    background."""

    def integrate(rays: Rays, keys):
        hit = intersect_scene(scene, rays)
        lrow = hit.light
        le = area_light_le(scene, lrow, -rays.d, hit.ns)
        is_emitter = lrow >= 0
        direct = _nee_area_lights(
            scene, statics, hit, rays.d, jnp.ones_like(le), keys, _SITE_LIGHT0,
        )
        out = jnp.where(is_emitter[:, None], le, direct)
        return jnp.where(hit.hit[:, None], out, jnp.full_like(le, 0.18))

    return integrate


def make_path_integrator(
    scene, statics, max_depth, nee=True, le_depth0_only=None,
    cosine_sampling=False, mis=False, with_stats=False,
    nee_mode="all", sort_rays="auto", pick_weights=None,
):
    """Indirect (``nee=False``) and GI (``nee=True``) path tracing
    (reference: Src/integrator.h:122-190 and 198-291).

    Reference semantics preserved: RR on mean throughput for depth > 0
    BEFORE the emitter check; emitter hits terminate the path; with NEE the
    emitter contributes only at depth 0 (no MIS, Src/integrator.h:236-244);
    without NEE it contributes at every depth; background is black;
    re-origin at +0.01*ng (flipped for glass transmission — live Mirror /
    Glass materials are an extension, see materials.py).

    ``mis=True`` (beyond the reference): NEE and BSDF light hits are
    combined with the power heuristic — emitter hits contribute at every
    depth, weighted against the light pdf for the sampled direction; light
    samples are weighted against the BSDF pdf. Lower variance than either
    strategy alone, unbiased.

    ``sort_rays`` (scheduling, not an estimator change — see
    geometry/raysort.py): re-sort the wavefront between bounces by
    (direction octant | origin Morton) and park dead lanes outside the
    scene, so neighbouring lanes carry coherent bounce/shadow rays.
    Images are bitwise identical with it on or off. "auto" = on when the
    triangle table is large (> 4096 rows).

    ``with_stats`` (SURVEY.md §5 metrics): ``integrate`` returns
    ``(radiance, stats)`` where stats maps each per-bounce counter
    ("rays", "shadow_rays", "rr_killed", "emitter_hits", "active_out")
    to a ``(max_depth,)`` int32 array summed over the wavefront — the
    renderer accumulates these across spp into ``RenderResult.stats``.
    """
    if mis:
        nee = True
        le_depth0_only = False
    if le_depth0_only is None:
        le_depth0_only = nee

    if sort_rays == "auto":
        try:
            n_real_tris = int(np.asarray(scene.tri_obj >= 0).sum())
        except Exception:  # traced tables (donated pytree): stay off
            n_real_tris = 0
        sort_on = max_depth > 1 and n_real_tris > 4096
    else:
        sort_on = bool(sort_rays) and max_depth > 1

    def integrate(rays: Rays, keys):
        n = rays.o.shape[0]

        if sort_on:
            from ..geometry.raysort import coherence_key, scene_bounds

            lo, hi = scene_bounds(scene)
            ext = jnp.maximum(hi - lo, 1e-30)
            inv_ext = 1.0 / ext
            park_o = hi + 10.0 * ext
            park_d = jnp.array([1.0, 0.0, 0.0], jnp.float32)

        def bounce(depth, state, do_sort=False):
            radiance, throughput, o, d, active, prev_pdf, prev_delta, stats = state[:8]
            if sort_on:
                keys_l, lane = state[8], state[9]
            else:
                keys_l = keys
            if do_sort:
                skey = coherence_key(o, d, active, lo, inv_ext)
                perm = jnp.argsort(skey, stable=True)
                (radiance, throughput, o, d, active, prev_pdf, prev_delta,
                 keys_l, lane) = (
                    jnp.take(a, perm, axis=0)
                    for a in (radiance, throughput, o, d, active, prev_pdf,
                              prev_delta, keys_l, lane)
                )
            n_in = jnp.sum(active.astype(jnp.int32)) if with_stats else None
            site = depth * SITES_PER_BOUNCE
            cur = Rays(o=o, d=d)
            hit = intersect_scene(scene, cur)

            # miss -> black background, kill (Src/integrator.h:216-221)
            active = active & hit.hit

            # Russian roulette for depth > 0 (Src/integrator.h:224-231)
            rr_prob = jnp.minimum(jnp.mean(throughput, axis=-1), 1.0)
            u_rr = uniform1(keys_l, site + _SITE_RR)
            do_rr = depth > 0
            # active-masked so the stats counter only counts real kills
            killed = active & do_rr & (u_rr >= rr_prob)
            active = active & ~killed
            throughput = jnp.where(
                (do_rr & active)[:, None],
                throughput / jnp.maximum(rr_prob, 1e-12)[:, None],
                throughput,
            )

            # emitter hit (Src/integrator.h:234-245)
            lrow = hit.light
            is_emitter = active & (lrow >= 0)
            le = area_light_le(scene, lrow, -d, hit.ns)
            if mis:
                # power-heuristic weight vs. the NEE pdf for this direction
                from ..lights import light_pdf_for_direction

                p_l = light_pdf_for_direction(scene, lrow, o, d, hit.t)
                w_b = prev_pdf ** 2 / jnp.maximum(
                    prev_pdf ** 2 + p_l ** 2, 1e-20
                )
                w_b = jnp.where((depth == 0) | prev_delta, 1.0, w_b)
                le = le * w_b[:, None]
                add_le = is_emitter
            else:
                add_le = is_emitter & (
                    (depth == 0) if le_depth0_only else jnp.bool_(True)
                )
            radiance = radiance + jnp.where(
                add_le[:, None], throughput * le, 0.0
            )
            active = active & ~is_emitter

            # NEE (Src/integrator.h:250-269)
            n_nee = jnp.sum(active.astype(jnp.int32)) if with_stats else None
            if nee and statics["n_area_lights"] > 0:
                direct = _nee_area_lights(
                    scene, statics, hit, d, throughput, keys_l,
                    site + _SITE_LIGHT0,
                    mis=mis, cosine_sampling=cosine_sampling,
                    nee_mode=nee_mode, active=active,
                    park=(park_o, park_d) if sort_on else None,
                    pick_weights=pick_weights,
                )
                radiance = radiance + jnp.where(
                    active[:, None], throughput * direct, 0.0
                )

            # BSDF bounce (Src/integrator.h:271-283)
            wo_l = world_to_local(-d, hit.dpdu, hit.ns, hit.dpdv)
            u2 = uniform2(keys_l, site + _SITE_BSDF)
            ul = uniform1(keys_l, site + _SITE_LOBE)
            bs = sample_bsdf_direct(
                hit.mtype, hit.albedo, hit.ior, wo_l, u2, ul, cosine_sampling
            )
            wi = local_to_world(bs.wi, hit.dpdu, hit.ns, hit.dpdv)
            throughput = jnp.where(
                active[:, None], throughput * bs.weight, throughput
            )
            # dead lanes from zero-weight bounces die too
            active = active & jnp.any(throughput > 0.0, axis=-1)
            incoming_sign = -jnp.sign(dot(d, hit.ng))
            sign = jnp.where(bs.flip_side, -incoming_sign, incoming_sign)
            o = jnp.where(
                active[:, None],
                hit.position + (sign * SHADOW_BIAS)[:, None] * hit.ng,
                o,
            )
            d = jnp.where(active[:, None], wi, d)
            if sort_on:
                # park dead lanes outside the bounds pointing away: rows of
                # dead lanes (sorted last) slab-reject every chunk/shadow
                # sweep. Dead lanes' o/d feed nothing unmasked.
                o = jnp.where(active[:, None], o, park_o)
                d = jnp.where(active[:, None], d, park_d)
            prev_pdf = jnp.where(active, bs.pdf, prev_pdf)
            prev_delta = jnp.where(active, bs.is_delta, prev_delta)
            if with_stats:
                n_lights = statics["n_area_lights"] if nee else 0
                if nee_mode in ("one", "power") and n_lights > 1:
                    n_lights = 1  # one shadow ray per vertex in this mode
                row = jnp.stack([
                    n_in,
                    n_nee * n_lights,
                    jnp.sum(killed.astype(jnp.int32)),
                    jnp.sum(is_emitter.astype(jnp.int32)),
                    jnp.sum(active.astype(jnp.int32)),
                ])
                stats = stats.at[depth].set(row)
            out = (radiance, throughput, o, d, active, prev_pdf, prev_delta,
                   stats)
            if sort_on:
                out = out + (keys_l, lane)
            return out

        state = (
            jnp.zeros((n, 3)),
            jnp.ones((n, 3)),
            rays.o,
            rays.d,
            jnp.ones((n,), bool),
            jnp.ones((n,)),
            jnp.zeros((n,), bool),
            jnp.zeros((max_depth, 5), jnp.int32),
        )
        if sort_on:
            state = state + (keys, jnp.arange(n, dtype=jnp.int32))
        # unroll small depths: straight-line code avoids the while-loop's
        # per-iteration carry copies and fuses across bounces; deep paths
        # fall back to fori_loop
        if max_depth <= 8:
            for depth in range(max_depth):
                state = bounce(depth, state, do_sort=sort_on and depth > 0)
        else:
            state = lax.fori_loop(
                0, max_depth, partial(bounce, do_sort=sort_on), state
            )
        radiance, stats = state[0], state[7]
        if sort_on:
            # scatter each lane's radiance back to its original slot so the
            # caller sees pixel order — bitwise equal to the unsorted path
            lane = state[9]
            radiance = jnp.zeros_like(radiance).at[lane].set(radiance)
        if with_stats:
            keys_ = ("rays", "shadow_rays", "rr_killed", "emitter_hits",
                     "active_out")
            return radiance, {k: stats[:, i] for i, k in enumerate(keys_)}
        return radiance

    return integrate


# numpy, NOT jnp: a module-scope jnp constant would initialize the JAX
# backend at package import (CPU-only tools could then no longer opt out)
_SKY = np.array([0.235294, 0.67451, 0.843137], np.float32)


def make_whitted_integrator(scene, statics, max_depth=3):
    """Whitted-style tracing (reference: Src/integrator.h:294-398).

    The reference's BFS ray queue becomes a single wavefront ray per lane:
    Lambert terminates with delta-light NEE; Metals reflect (throughput
    x0.8); Glass picks reflect/refract stochastically by Fresnel weight
    (throughput x0.9) — the queue's both-branch splitting
    (Src/integrator.h:355-381) replaced by unbiased one-sample selection,
    which averages to the same image over spp. Sky color on miss and on
    depth overflow (Src/integrator.h:317-320,385-389). Reference quirks kept:
    shadow bias 0.1 (not 0.01), shadow range t_max (not t_max - bias), NEE
    cos against the SHADING normal (Src/integrator.h:334-339).
    """

    def integrate(rays: Rays, keys):
        n = rays.o.shape[0]

        def bounce(depth, state):
            radiance, throughput, o, d, active = state
            site = depth * SITES_PER_BOUNCE
            cur = Rays(o=o, d=d)
            hit = intersect_scene(scene, cur)

            missed = active & ~hit.hit
            radiance = radiance + jnp.where(
                missed[:, None], throughput * _SKY, 0.0
            )
            active = active & hit.hit

            mtype = hit.mtype

            # Lambert: delta-light NEE, terminate (Src/integrator.h:328-343)
            is_lambert = active & (mtype == 0)
            direct = jnp.zeros((n, 3))
            for i in range(statics["n_delta_lights"]):
                lidx = jnp.full((n,), i, jnp.int32)
                ls = sample_delta_light(scene, lidx, hit.position)
                srays = Rays(o=hit.position + hit.ng * 0.1, d=ls.wi)
                vis = ~occluded(scene, srays, ls.t_max)
                cos = jnp.maximum(0.0, dot(hit.ns, ls.wi))
                wo_l = world_to_local(-d, hit.dpdu, hit.ns, hit.dpdv)
                wi_l = world_to_local(ls.wi, hit.dpdu, hit.ns, hit.dpdv)
                fr = eval_bsdf_direct(hit.mtype, hit.albedo, wo_l, wi_l)
                pdf = jnp.where(ls.pdf == 0.0, 1.0, ls.pdf)
                direct = direct + vis[:, None] * fr * ls.le * (cos / pdf)[:, None]
            radiance = radiance + jnp.where(
                is_lambert[:, None], throughput * direct, 0.0
            )
            # unknown/no material also terminates (reference default: break)
            active = active & (mtype >= 1)

            # Metals / Glass via the delta lobes of sample_bsdf
            wo_l = world_to_local(-d, hit.dpdu, hit.ns, hit.dpdv)
            u2 = uniform2(keys, site + _SITE_BSDF)
            ul = uniform1(keys, site + _SITE_LOBE)
            bs = sample_bsdf_direct(hit.mtype, hit.albedo, hit.ior, wo_l, u2, ul)
            wi = local_to_world(bs.wi, hit.dpdu, hit.ns, hit.dpdv)
            throughput = jnp.where(
                active[:, None], throughput * bs.weight, throughput
            )
            incoming_sign = -jnp.sign(dot(d, hit.ng))
            sign = jnp.where(bs.flip_side, -incoming_sign, incoming_sign)
            o = jnp.where(
                active[:, None],
                hit.position + (sign * 0.001)[:, None] * hit.ng,
                o,
            )
            d = jnp.where(active[:, None], wi, d)
            return radiance, throughput, o, d, active

        state = (
            jnp.zeros((n, 3)),
            jnp.ones((n, 3)),
            rays.o,
            rays.d,
            jnp.ones((n,), bool),
        )
        if max_depth <= 8:
            for depth in range(max_depth + 1):
                state = bounce(depth, state)
            radiance, throughput, o, d, active = state
        else:
            radiance, throughput, o, d, active = lax.fori_loop(
                0, max_depth + 1, bounce, state
            )
        # depth-overflow rays: sky (Src/integrator.h:317-320)
        radiance = radiance + jnp.where(active[:, None], throughput * _SKY, 0.0)
        return radiance

    return integrate
