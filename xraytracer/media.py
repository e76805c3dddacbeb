"""Participating media: free-flight sampling, tracking loops, transmittance.

Wavefront counterpart of the reference's ``Medium`` hierarchy (reference:
Src/medium.h:71-387, Src/medium.cpp). The reference's unbounded per-ray
``while(true)`` delta-/ratio-tracking loops (Src/medium.cpp:56,
Src/medium.h:335,369) become a single wavefront ``lax.while_loop`` with
per-lane active masks and a hard ``max_steps`` bound (SURVEY.md §7 "hard
parts"): the loop exits early when every lane has resolved, and lanes that
would exceed the bound are terminated with throughput 0 (counted, never
silently biased high).

Spectral MIS follows the reference (Pixar memo 17-07 channel selection,
Src/medium.h:97-115): a channel is picked proportional to
throughput * albedo, and the single-sample MIS weight sums the pdf over
channels.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .constants import RAY_EPS
from .math import dot, length, normalize
from .sampling import (
    hg_phase,
    hg_sample_direction,
    sample_channel,
    uniform1,
    uniform2,
)
from .scene.tables import (
    MED_HETEROGENEOUS,
    MED_HOMOG_ACHROMATIC,
    MED_HOMOG_MIS,
    MED_HOMOG_NOMIS,
)

# Random sites consumed per tracking-loop iteration (wavelength, distance,
# event, phase-direction pair). Integrators reserve
# ``max_steps * SITES_PER_STEP`` sites for each sampleMedium call.
SITES_PER_STEP = 4


class MediumSample(NamedTuple):
    """Result of one ``sampleMedium`` over the wavefront."""

    pos: jnp.ndarray        # (N, 3) new ray origin
    dir: jnp.ndarray        # (N, 3) new ray direction
    weight: jnp.ndarray     # (N, 3) throughput multiplier
    scattered: jnp.ndarray  # (N,) bool — real in-scatter event


def gather_medium(scene, med_idx):
    """Medium-table row gather with -1 guarded to row 0."""
    m = jnp.maximum(med_idx, 0)
    return dict(
        mtype=jnp.where(med_idx >= 0, scene.med_type[m], -1),
        g=scene.med_g[m],
        sigma_a=scene.med_sigma_a[m],
        sigma_s=scene.med_sigma_s[m],
        majorant=scene.med_majorant[m],
        density_mult=scene.med_density_mult[m],
    )


def _grid_coords(scene, p):
    g = scene.grid_density
    res = jnp.asarray(g.shape, jnp.float32)
    ext = scene.grid_max - scene.grid_min
    # voxel centers span the bounds: continuous index in [0, res-1]
    x = (p - scene.grid_min[None, :]) / ext[None, :] * (res[None, :] - 1.0)
    inside = jnp.all(
        (p >= scene.grid_min[None, :]) & (p <= scene.grid_max[None, :]), axis=-1
    )
    x = jnp.clip(x, 0.0, res[None, :] - 1.0)
    x0 = jnp.floor(x)
    return x0.astype(jnp.int32), x - x0, inside


def density_lookup(scene, p, use_packed=True):
    """World-space trilinear density (reference: Src/grid.h:71-77, the
    OpenVDB ``BoxSampler`` world lookup; outside the bounds the VDB
    background value 0 applies). ``p``: (N, 3) -> (N,) density.

    Hot-path formulation (``use_packed``): ONE row gather from the
    corner-packed (Nx*Ny*Nz, 8) table followed by a weight dot, in place
    of 8 separate corner gathers. The unpacked path gathers from
    ``grid_density`` directly so gradients flow to the real grid parameter
    (the packed table is a derived buffer)."""
    g = scene.grid_density
    nx, ny, nz = g.shape
    i0, f, inside = _grid_coords(scene, p)
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    wx = jnp.concatenate([1.0 - fx, fx], axis=1)         # (N, 2)
    wy = jnp.concatenate([1.0 - fy, fy], axis=1)
    wz = jnp.concatenate([1.0 - fz, fz], axis=1)
    # weight for corner d = wx[dx] * wy[dy] * wz[dz], d = dx*4 + dy*2 + dz
    w = (
        wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    ).reshape(-1, 8)
    # huge grids ship no packed table (it is 8x the grid; scene/builder
    # gates it by size and stores a 1-row sentinel); fall back to the
    # 8-corner dense gather for them
    if use_packed and scene.grid_packed.shape[0] != g.size:
        use_packed = False
    if use_packed:
        flat = (i0[:, 0] * ny + i0[:, 1]) * nz + i0[:, 2]
        corners = scene.grid_packed[flat]                # (N, 8)
    else:
        lim = jnp.asarray(g.shape, jnp.int32)[None, :] - 1
        i1 = jnp.minimum(i0 + 1, lim)
        cs = []
        for d in range(8):
            ix = i1[:, 0] if (d >> 2) & 1 else i0[:, 0]
            iy = i1[:, 1] if (d >> 1) & 1 else i0[:, 1]
            iz = i1[:, 2] if d & 1 else i0[:, 2]
            cs.append(g[ix, iy, iz])
        corners = jnp.stack(cs, axis=-1)
    val = jnp.sum(corners * w, axis=-1)
    return jnp.where(inside, val, 0.0)


def _free_flight(u, sigma):
    """t = -ln(max(1-u, 0)) / sigma (reference: Src/medium.h:168-169)."""
    return -jnp.log(jnp.maximum(1.0 - u, 1e-38)) / sigma


# --- piecewise-majorant (supergrid) tracking ------------------------------
#
# Replacement for global-majorant null-collision loops: with a global
# majorant every tracking iteration pays one density gather per lane, and
# sparse grids (the wdas cloud) make most of those steps null collisions
# in empty space. Instead:
#
#  1. Walk each lane's ray through a <=8^3 block-max supergrid with a
#     fixed-unroll DDA (elementwise math; the block-majorant lookup is an
#     exact one-hot reduce over <=512 rows), producing per-lane
#     piecewise-constant majorant segments.
#  2. Track in OPTICAL-DEPTH space: candidate collisions are unit-rate
#     exponential arrivals in tau = ∫majorant; block crossings disappear
#     into a closed-form cumsum + vectorized piecewise inversion.
#  3. Only genuine collision candidates pay the fine trilinear gather, and
#     their expected count is ∫(local majorant) — far below
#     global_majorant * path_length for sparse media.
#
# For a single-block supergrid this reproduces the global-majorant
# algorithm draw-for-draw (t = t0 + tau/m is the same free-flight mapping).

_DDA_SEGMENTS = 24  # >= nbx+nby+nbz - 2 (<= 22 for 8^3 blocks) + margin


def _super_lookup(scene, b):
    """Exact supergrid pick for (N, 3) int32 block coords, as a separable
    3-stage one-hot contraction: one (X*Y, Z) @ (Z, N) matmul (Z <= 8)
    plus two 8-wide masked reduces. Never an (N, 512) materialization
    (25 DDA steps x 134 MB of intermediates for the naive one-hot
    reduce), and exact in f32 (one nonzero per reduction; HIGHEST
    precision so a reduced-precision product cannot round a majorant DOWN
    and break the sig_n >= 0 invariant)."""
    import numpy as np

    nb = tuple(int(v) for v in np.asarray(scene.grid_super_nb))
    sg3 = scene.grid_super.reshape(nb)                  # (X, Y, Z)
    x_, y_, z_ = nb
    ohz = (
        b[:, 2][:, None] == jnp.arange(z_, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)                               # (N, Z)
    t1 = jax.lax.dot_general(
        sg3.reshape(x_ * y_, z_), ohz,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(x_, y_, -1)                               # (X, Y, N)
    ohy = b[:, 1][None, :, None] == jnp.arange(y_, dtype=jnp.int32)[None, None, :]
    # (X, N, Y) x (1, N, Y) -> (X, N)
    t2 = jnp.sum(jnp.where(ohy, t1.transpose(0, 2, 1), 0.0), axis=-1)
    ohx = b[:, 0][None, :] == jnp.arange(x_, dtype=jnp.int32)[:, None]
    return jnp.sum(jnp.where(ohx, t2, 0.0), axis=0)     # (N,)


def _majorant_segments(scene, med, rays, t0, t1):
    """Per-lane piecewise-constant majorant over [t0, t1].

    Returns (seg_t, seg_m, tau_edges): segment start times (N, K+1), local
    majorants (N, K+1) and cumulative optical depth at segment starts plus
    the final edge (N, K+2), where K = _DDA_SEGMENTS and segment K is a
    global-majorant tail that covers any remainder if the fixed unroll ran
    out (a true upper bound is preserved in all cases)."""
    n = rays.o.shape[0]
    nb = scene.grid_super_nb            # (3,) int32, concrete at trace time
    bs = scene.grid_super_bsize
    res = jnp.asarray(scene.grid_density.shape, jnp.float32)
    ext = scene.grid_max - scene.grid_min
    scale = (res - 1.0) / jnp.where(ext == 0.0, 1.0, ext)
    a = (rays.o - scene.grid_min[None, :]) * scale[None, :]   # index space
    v = rays.d * scale[None, :]
    sigma_t_max = jnp.max(med["sigma_a"] + med["sigma_s"], axis=-1)
    dm = med["density_mult"]

    t0f = jnp.where(jnp.isfinite(t0), t0, 0.0)
    t1f = jnp.where(jnp.isfinite(t1), jnp.maximum(t1, t0f), t0f)

    nbf = nb.astype(jnp.float32)
    # Integer-walk DDA: the block index advances along the exiting axis
    # (first-min tie-break), so the majorant SEQUENCE is a function of
    # integer state — robust to 1-ulp FMA-contraction differences between
    # compiled pipelines (CPU vs GPU) and never stalls on block boundaries
    # like a refloor-plus-nudge formulation does. Unrolled: a fixed
    # _DDA_SEGMENTS-step straight-line walk.
    x0 = a + t0f[:, None] * v
    b = jnp.clip(jnp.floor(x0 / bs[None, :]), 0.0, nbf[None, :] - 1.0)
    sgn = jnp.where(v >= 0.0, 1.0, -1.0)
    axes3 = jnp.arange(3)
    seg_t = []
    seg_m = []
    t_cur = t0f
    for _ in range(_DDA_SEGMENTS):
        dens_max = _super_lookup(scene, b.astype(jnp.int32))
        m_loc = dens_max * dm * sigma_t_max
        # exit time of the current block along each axis
        lo = b * bs[None, :]
        hi = (b + 1.0) * bs[None, :]
        v_safe = jnp.where(jnp.abs(v) < 1e-20, 1e-20, v)
        t_exit_ax = jnp.where(
            v > 1e-20, (hi - a) / v_safe,
            jnp.where(v < -1e-20, (lo - a) / v_safe, jnp.inf),
        )
        t_hi = jnp.min(t_exit_ax, axis=-1)
        ax = jnp.argmin(t_exit_ax, axis=-1)
        seg_t.append(t_cur)
        seg_m.append(jnp.where(t_cur < t1f, m_loc, 0.0))
        b = jnp.clip(
            b + (axes3[None, :] == ax[:, None]) * sgn,
            0.0, nbf[None, :] - 1.0,
        )
        t_cur = jnp.minimum(jnp.maximum(t_hi, t_cur), t1f)
    # tail segment: global majorant over any remainder (fixed unroll ran out)
    t_tail = jnp.minimum(t_cur, t1f)
    seg_t.append(t_tail)
    seg_m.append(jnp.where(t_tail < t1f, med["majorant"], 0.0))

    seg_t = jnp.stack(seg_t, axis=1)                     # (N, K+1)
    seg_m = jnp.stack(seg_m, axis=1)
    ends = jnp.concatenate([seg_t[:, 1:], t1f[:, None]], axis=1)
    seg_len = jnp.maximum(ends - seg_t, 0.0)
    dtau = seg_m * seg_len
    # sequential (left-to-right) edge accumulation: jnp.cumsum's scan tree
    # rounds differently per backend (~1e-4 at tau ~ 10), which would
    # desync tracking decisions between compiled pipelines
    edges = [jnp.zeros((n,))]
    for k in range(dtau.shape[1]):
        edges.append(edges[-1] + dtau[:, k])
    tau_edges = jnp.stack(edges, axis=1)                 # (N, K+2)
    return seg_t, seg_m, tau_edges


def _tau_to_t(seg_t, seg_m, tau_edges, tau):
    """Invert the piecewise-linear tau(t): (N,) tau -> (t, m_loc).
    Elementwise (one-hot over K+1 segments, no gathers)."""
    k = jnp.sum(
        (tau_edges[:, :-1] <= tau[:, None]).astype(jnp.int32), axis=1
    ) - 1
    k = jnp.clip(k, 0, seg_m.shape[1] - 1)
    oh = k[:, None] == jnp.arange(seg_m.shape[1], dtype=jnp.int32)[None, :]
    m_loc = jnp.sum(jnp.where(oh, seg_m, 0.0), axis=1)
    t_k = jnp.sum(jnp.where(oh, seg_t, 0.0), axis=1)
    tau_k = jnp.sum(jnp.where(oh, tau_edges[:, :-1], 0.0), axis=1)
    t = t_k + (tau - tau_k) / jnp.where(m_loc <= 0.0, 1.0, m_loc)
    return t, m_loc


def _analytic_tr(t, sigma):
    """exp(-sigma t) (reference: Src/medium.h:92-95)."""
    return jnp.exp(-sigma * t[..., None])


def _sample_homogeneous(med, rays, t0, t1, path_throughput, keys, site):
    """All three homogeneous variants, branch-free (reference:
    Src/medium.h:148-277). Free flight is measured from the box ENTRY point
    ``t0`` — the segment before the box is vacuum (Src/medium.h:183,225,270).
    """
    sigma_t = med["sigma_a"] + med["sigma_s"]
    sigma_s = med["sigma_s"]
    mtype = med["mtype"]

    u_wl = uniform1(keys, site + 0)
    u_dist = uniform1(keys, site + 1)
    u_phase = uniform2(keys, site + 2)

    # channel selection per variant
    albedo = sigma_s / jnp.where(sigma_t == 0.0, 1.0, sigma_t)
    ch_mis, pmf_mis = sample_channel(path_throughput * albedo, u_wl)
    ch_nomis = jnp.minimum((3.0 * u_wl).astype(jnp.int32), 2)
    is_mis = mtype == MED_HOMOG_MIS
    is_achro = mtype == MED_HOMOG_ACHROMATIC
    channel = jnp.where(is_mis, ch_mis, jnp.where(is_achro, 0, ch_nomis))
    pmf = jnp.where(
        is_mis[:, None], pmf_mis, jnp.full_like(pmf_mis, 1.0 / 3.0)
    )

    sig_c = jnp.take_along_axis(sigma_t, channel[:, None], axis=-1)[:, 0]
    sig_c = jnp.where(sig_c == 0.0, 1.0, sig_c)
    t = _free_flight(u_dist, sig_c)
    dist = t1 - t0
    escaped = t > dist - RAY_EPS

    # escape weight (single-sample MIS over channels; achromatic = 1)
    tr_d = _analytic_tr(dist, sigma_t)
    pdf_esc = jnp.sum(pmf * tr_d, axis=-1, keepdims=True)
    w_esc = tr_d / jnp.where(pdf_esc == 0.0, 1.0, pdf_esc)
    w_esc = jnp.where(is_achro[:, None], 1.0, w_esc)

    # scatter weight
    tr_t = _analytic_tr(t, sigma_t)
    pdf_sc = jnp.sum(pmf * sigma_t * tr_t, axis=-1, keepdims=True)
    w_sc = tr_t * sigma_s / jnp.where(pdf_sc == 0.0, 1.0, pdf_sc)
    w_achro = sigma_s / jnp.where(sigma_t == 0.0, 1.0, sigma_t)
    w_sc = jnp.where(is_achro[:, None], w_achro, w_sc)

    new_dir, _ = hg_sample_direction(rays.d, u_phase[:, 0], u_phase[:, 1], med["g"])

    pos = jnp.where(
        escaped[:, None], rays.at(t1 + RAY_EPS), rays.at(t0 + t)
    )
    d = jnp.where(escaped[:, None], rays.d, new_dir)
    weight = jnp.where(escaped[:, None], w_esc, w_sc)
    return MediumSample(pos=pos, dir=d, weight=weight, scattered=~escaped)


def _score_ratio(p, p_min=1e-5):
    """``p / stop_grad(p)`` with guards: value exactly 1, gradient the
    score term ∂log p. Multiplying a path weight by this for every SAMPLED
    discrete event whose probability depends on the differentiated
    parameters turns the detached-sampling (fixed-stream) gradient into
    the full score-corrected estimator d/dθ E[F] = E[dF + F·dlog p]
    (differential delta tracking / radiative-backprop style) — the forward
    value is untouched, and downstream contributions inherit the factor
    through the throughput product.

    Events with probability below ``p_min`` carry NO score (gradient
    clipped to 0): ∂log p = ∂p/p explodes as p -> 0 when a
    probability-~0 branch happens to be sampled (observed: NaN'd Adam on
    a dense grid where p_null ~ 1e-8 events were drawn), and the clipped
    estimator's bias is O(p_min) while its variance is bounded — the
    standard score-clipping compromise."""
    ps = jax.lax.stop_gradient(p)
    safe = ps > p_min
    return jnp.where(safe, p, 1.0) / jnp.where(safe, ps, 1.0)


def _sample_heterogeneous(
    scene, med, rays, t0, t1, path_throughput, keys, site, max_steps,
    differentiable=False, het_mask=None, score_terms=False,
):
    """Weighted delta tracking with spectral MIS (reference:
    Src/medium.cpp:45-133), as a bounded masked ``while_loop`` over
    COLLISION CANDIDATES in optical-depth space with per-lane piecewise
    block majorants (see the supergrid note above `_majorant_segments`).
    The reference's per-step mechanics (channel pick, escape weight,
    scatter/null split, NaN guards) are preserved with the local majorant
    in place of the global one; for a single-block supergrid the draws are
    identical to the global-majorant algorithm.

    State machine per lane: tracking -> {escaped, scattered, exhausted}.
    Exhausted lanes (step bound hit) get weight 0 — a biased-dark, never
    biased-bright, failure mode; the bound is sized by the caller from
    majorant * bbox diagonal (a valid upper bound on expected candidates,
    loose for sparse grids where the local majorants dominate).
    """
    n = rays.o.shape[0]
    dm = med["density_mult"]

    seg_t, seg_m, tau_edges = _majorant_segments(scene, med, rays, t0, t1)
    tau_total = tau_edges[:, -1] - RAY_EPS * med["majorant"]  # t1 - RAY_EPS

    # initial sigma_a at the entry point, for the first channel pick
    # (Src/medium.cpp:52-54)
    sigma_a0 = med["sigma_a"] * (
        density_lookup(scene, rays.at(t0), use_packed=not differentiable) * dm
    )[:, None]

    def body(state):
        (step, active, tau, w_track, sigma_a, m_prev, _pos, scat_step,
         scattered) = state
        s_base = site + step * SITES_PER_STEP
        u_wl = uniform1(keys, s_base + 0)
        u_dist = uniform1(keys, s_base + 1)
        u_ev = uniform1(keys, s_base + 2)

        # channel-pick weights: single-scatter albedo proxy vs the LOCAL
        # majorant (reference uses the global one, Src/medium.cpp:58-60);
        # clamped >= 0 for stale-majorant safety — the pick pmf is always
        # accounted in the pdfs, so any positive weighting stays unbiased
        m_prev_s = jnp.where(m_prev <= 0.0, 1.0, m_prev)
        alb = jnp.maximum(
            (m_prev[:, None] - sigma_a) / m_prev_s[:, None], 0.0
        )
        channel, pmf = sample_channel(path_throughput * w_track * alb, u_wl)

        dtau = -jnp.log(jnp.maximum(1.0 - u_dist, 1e-38))   # Exp(1) in tau
        tau_new = tau + dtau

        # boundary escape (Src/medium.cpp:70-93); with a scalar majorant the
        # channel-independent exp factors cancel between weight and pdf,
        # leaving w_esc = w_track / sum(pmf) — kept literal for parity
        esc = tau_new > tau_total
        tr_esc = jnp.exp(-(tau_total - tau))[:, None] * jnp.ones((1, 3))
        pdf_esc = jnp.sum(pmf * tr_esc, axis=-1, keepdims=True)
        w_esc = w_track * tr_esc / jnp.where(pdf_esc == 0.0, 1.0, pdf_esc)

        t_new, m_loc = _tau_to_t(seg_t, seg_m, tau_edges, tau_new)
        m_safe = jnp.where(m_loc <= 0.0, 1.0, m_loc)
        dens = density_lookup(
            scene, rays.at(t_new), use_packed=not differentiable
        ) * dm
        sig_s = med["sigma_s"] * dens[:, None]
        sig_a = med["sigma_a"] * dens[:, None]
        # clamped at 0: the supergrid majorant bounds the trilinear field by
        # construction; stale majorants after a grid_density override can
        # undershoot, which must bias (slightly) rather than go negative
        sig_n = jnp.maximum(m_loc[:, None] - sig_a - sig_s, 0.0)
        denom = jnp.where((sig_s + sig_n) == 0.0, 1.0, sig_s + sig_n)
        p_s = sig_s / denom
        p_n = sig_n / denom
        p_s_c = jnp.take_along_axis(p_s, channel[:, None], axis=-1)[:, 0]

        tr_s = jnp.exp(-dtau)[:, None] * jnp.ones((1, 3))
        # in-scatter (Src/medium.cpp:104-124)
        scat = ~esc & (u_ev < p_s_c)
        pdf_sc = jnp.sum(pmf * m_safe[:, None] * tr_s * p_s, axis=-1, keepdims=True)
        w_scat = w_track * tr_s * sig_s / jnp.where(pdf_sc == 0.0, 1.0, pdf_sc)
        # null-scatter (Src/medium.cpp:126-131)
        pdf_nl = jnp.sum(pmf * m_safe[:, None] * tr_s * p_n, axis=-1, keepdims=True)
        w_null = w_track * tr_s * sig_n / jnp.where(pdf_nl == 0.0, 1.0, pdf_nl)

        if score_terms:
            # score-corrected gradients (see _score_ratio): the θ-dependent
            # SAMPLED events in the chain are the channel pick (prob
            # pmf[channel] — a function of albedo/throughput) and the
            # scatter-vs-null split (prob p_s_c / 1 - p_s_c — functions of
            # the density field). Distance draws and escape are sampled
            # w.r.t. the MAJORANT tables (grid_super / med_majorant),
            # which are independent leaves the optimizer holds fixed, so
            # they carry no score. Values are unchanged (ratio == 1).
            r_pick = _score_ratio(
                jnp.take_along_axis(pmf, channel[:, None], axis=-1)
            )
            w_esc = w_esc * r_pick
            w_scat = w_scat * r_pick * _score_ratio(p_s_c[:, None])
            w_null = w_null * r_pick * _score_ratio(1.0 - p_s_c[:, None])

        done = active & (esc | scat)
        pos_out = jnp.where(
            (active & esc)[:, None], rays.at(t1 + RAY_EPS), _pos
        )
        pos_out = jnp.where((active & scat)[:, None], rays.at(t_new), pos_out)
        # the phase-direction draw is hoisted out of the loop: record the
        # scatter step so the site can be replayed afterwards
        scat_step = jnp.where(active & scat, step, scat_step)
        w_out = jnp.where((active & esc)[:, None], w_esc, w_track)
        w_out = jnp.where((active & scat)[:, None], w_scat, w_out)
        w_track_new = jnp.where((active & ~esc & ~scat)[:, None], w_null, w_out)
        scattered = scattered | (active & scat)
        active = active & ~done
        tau = jnp.where(active, tau_new, tau)
        return (
            step + 1, active, tau, w_track_new, sig_a, m_loc, pos_out,
            scat_step, scattered,
        )

    def cond(state):
        step, active = state[0], state[1]
        return (step < max_steps) & jnp.any(active)

    _, m_entry = _tau_to_t(seg_t, seg_m, tau_edges, jnp.zeros((n,)))
    # lanes outside the heterogeneous medium (masked out by the caller)
    # must not drive the while_loop: a surface-hit lane carries t1 = INF
    # (finite under isfinite!), whose tail segment would otherwise null-
    # scatter to max_steps every call
    active0 = jnp.ones((n,), bool) if het_mask is None else het_mask
    init = (
        jnp.int32(0),
        active0,
        jnp.zeros((n,)),        # tau
        jnp.ones((n, 3)),
        sigma_a0,
        jnp.maximum(m_entry, 0.0),
        rays.at(t1 + RAY_EPS),  # default: pass through (overwritten when done)
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), bool),
    )
    if differentiable:
        # fixed-trip fori (reverse-mode differentiable; while_loop is not):
        # masked lanes idle but every step has a defined cotangent
        state = init
        state = lax.fori_loop(0, max_steps, lambda i, st: body(st), state)
        step, active, _t, w_track, _sa, _m, pos, scat_step, scattered = state
    else:
        step, active, _t, w_track, _sa, _m, pos, scat_step, scattered = (
            lax.while_loop(cond, body, init)
        )
    # phase direction, drawn once at the recorded scatter step's site
    u_ph = uniform2(keys, site + scat_step * SITES_PER_STEP + 3)
    new_dir, _ = hg_sample_direction(rays.d, u_ph[:, 0], u_ph[:, 1], med["g"])
    d = jnp.where(scattered[:, None], new_dir, rays.d)
    # exhausted lanes: kill with weight 0 (bounded-loop policy)
    weight = jnp.where(active[:, None], 0.0, w_track)
    # NaN guard (Src/medium.cpp:83-91,113-121)
    weight = jnp.where(jnp.isnan(weight).any(axis=-1, keepdims=True), 0.0, weight)
    return MediumSample(pos=pos, dir=d, weight=weight, scattered=scattered)


def sample_medium(
    scene, med_idx, rays, t0, t1, path_throughput, keys, site,
    max_steps=256, has_heterogeneous=True, has_homogeneous=True,
    differentiable=False, score_terms=False,
):
    """Wavefront ``Object::sampleMedium`` dispatch (reference:
    Src/primitive.cpp:63-74 -> Src/medium.h:148-277 / Src/medium.cpp:45-133).

    ``med_idx``: (N,) medium row per lane (-1 = no medium -> pass-through
    with weight 1). The static ``has_*`` flags (from ``scene_statics``) let
    integrators skip compiling the unused branch entirely.
    """
    med = gather_medium(scene, med_idx)
    n = rays.o.shape[0]
    none = MediumSample(
        pos=rays.at(t1 + RAY_EPS),
        dir=rays.d,
        weight=jnp.ones((n, 3)),
        scattered=jnp.zeros((n,), bool),
    )
    parts = [none]
    masks = [med["mtype"] < 0]
    if has_homogeneous:
        parts.append(_sample_homogeneous(med, rays, t0, t1, path_throughput, keys, site))
        masks.append((med["mtype"] >= 0) & (med["mtype"] != MED_HETEROGENEOUS))
    if has_heterogeneous:
        het_mask = med["mtype"] == MED_HETEROGENEOUS
        parts.append(
            _sample_heterogeneous(
                scene, med, rays, t0, t1, path_throughput, keys, site,
                max_steps, differentiable=differentiable,
                het_mask=het_mask, score_terms=score_terms,
            )
        )
        masks.append(het_mask)

    out = parts[0]
    for p, m in zip(parts[1:], masks[1:]):
        out = MediumSample(
            pos=jnp.where(m[:, None], p.pos, out.pos),
            dir=jnp.where(m[:, None], p.dir, out.dir),
            weight=jnp.where(m[:, None], p.weight, out.weight),
            scattered=jnp.where(m, p.scattered, out.scattered),
        )
    return out


def segment_transmittance(
    scene, med_idx, p1, p2, keys, site, max_steps=256, differentiable=False,
):
    """Transmittance between two points through one medium segment
    (reference: ``Object::sampleTransparency`` -> ``Medium::transmittance``;
    homogeneous = analytic exp(-sigma_t d) Src/medium.h:133-139,
    heterogeneous = ratio tracking Src/medium.h:360-386).

    ``med_idx`` < 0 lanes return 1.
    """
    med = gather_medium(scene, med_idx)
    n = p1.shape[0]
    dist = length(p2 - p1)
    safe = jnp.where(dist == 0.0, 1.0, dist)
    d = (p2 - p1) / safe[:, None]

    # homogeneous: analytic
    sigma_t = med["sigma_a"] + med["sigma_s"]
    tr_h = _analytic_tr(dist, sigma_t)

    # heterogeneous: ratio tracking over collision candidates in optical-
    # depth space with piecewise block majorants (see _majorant_segments) —
    # unbiased: E[prod(sig_n/m)] over Poisson(m) arrivals = exp(-int sigma_t)
    is_het = med["mtype"] == MED_HETEROGENEOUS
    dm = med["density_mult"]
    from .geometry.types import Rays as _Rays

    srays = _Rays(o=p1, d=d)
    seg_t, seg_m, tau_edges = _majorant_segments(
        scene, med, srays, jnp.zeros((n,)), dist
    )
    tau_total = tau_edges[:, -1]

    def body(state):
        step, active, tau, tr = state
        u = uniform1(keys, site + step)
        tau_new = tau - jnp.log(jnp.maximum(1.0 - u, 1e-38))
        esc = tau_new > tau_total
        t_new, m_loc = _tau_to_t(seg_t, seg_m, tau_edges, tau_new)
        dens = density_lookup(
            scene, p1 + t_new[:, None] * d, use_packed=not differentiable
        ) * dm
        m_safe = jnp.where(m_loc <= 0.0, 1.0, m_loc)[:, None]
        sig_n = jnp.maximum(
            m_loc[:, None]
            - (med["sigma_a"] + med["sigma_s"]) * dens[:, None],
            0.0,
        )
        tr_new = jnp.where(
            (active & ~esc)[:, None], tr * sig_n / m_safe, tr
        )
        active = active & ~esc
        tau = jnp.where(active, tau_new, tau)
        return step + 1, active, tau, tr_new

    def cond(state):
        step, active = state[0], state[1]
        return (step < max_steps) & jnp.any(active)

    init = (jnp.int32(0), is_het, jnp.zeros((n,)), jnp.ones((n, 3)))
    if differentiable:
        _, active, _, tr_r = lax.fori_loop(
            0, max_steps, lambda i, st: body(st), init
        )
    else:
        _, active, _, tr_r = lax.while_loop(cond, body, init)
    # exhausted lanes -> 0 (never biased bright)
    tr_r = jnp.where(active[:, None], 0.0, tr_r)

    tr = jnp.where(is_het[:, None], tr_r, tr_h)
    return jnp.where((med["mtype"] >= 0)[:, None], tr, 1.0)


def delta_tracking_transmittance(
    scene, med_idx, p1, p2, keys, site, max_steps=256,
):
    """Delta-tracking (binary) transmittance estimator — the reference's
    alternate to ratio tracking (Src/medium.h:321-358): pick a channel
    uniformly, walk majorant free flights, and on a real/absorption
    collision return 0; survivors accumulate the channel-ratio weight.
    Higher variance than ratio tracking but each step is cheaper; provided
    for parity and for variance experiments. ``med_idx`` < 0 lanes return 1.
    """
    med = gather_medium(scene, med_idx)
    n = p1.shape[0]
    dist = length(p2 - p1)
    safe = jnp.where(dist == 0.0, 1.0, dist)
    d = (p2 - p1) / safe[:, None]
    majorant = med["majorant"]
    inv_maj = 1.0 / jnp.where(majorant == 0.0, 1.0, majorant)
    dm = med["density_mult"]
    # uniform channel pick (sampleWavelength with unit weights,
    # Src/medium.h:330-333)
    ch = jnp.minimum((3.0 * uniform1(keys, site)).astype(jnp.int32), 2)

    def body(state):
        step, active, t, tr = state
        u = uniform1(keys, site + 1 + step * 2)
        s = _free_flight(u, majorant)
        t_new = t + s
        esc = t_new > dist
        dens = density_lookup(scene, p1 + t_new[:, None] * d) * dm
        sig_n = majorant[:, None] - (
            med["sigma_a"] + med["sigma_s"]
        ) * dens[:, None]
        p_n = sig_n * inv_maj[:, None]
        p_n_c = jnp.take_along_axis(p_n, ch[:, None], axis=-1)[:, 0]
        u_ev = uniform1(keys, site + 2 + step * 2)
        collide = active & ~esc & (u_ev > p_n_c)
        sig_n_c = jnp.take_along_axis(sig_n, ch[:, None], axis=-1)[:, 0]
        ratio = sig_n / jnp.where(sig_n_c == 0.0, 1.0, sig_n_c)[:, None]
        tr = jnp.where((active & ~esc & ~collide)[:, None], tr * ratio, tr)
        tr = jnp.where(collide[:, None], 0.0, tr)
        active = active & ~esc & ~collide
        t = jnp.where(active, t_new, t)
        return step + 1, active, t, tr

    def cond(state):
        return (state[0] < max_steps) & jnp.any(state[1])

    is_het = med["mtype"] == MED_HETEROGENEOUS
    init = (jnp.int32(0), is_het, jnp.zeros((n,)), jnp.ones((n, 3)))
    _, active, _, tr_r = lax.while_loop(cond, body, init)
    tr_r = jnp.where(active[:, None], 0.0, tr_r)

    sigma_t = med["sigma_a"] + med["sigma_s"]
    tr_h = _analytic_tr(dist, sigma_t)
    tr = jnp.where(is_het[:, None], tr_r, tr_h)
    return jnp.where((med["mtype"] >= 0)[:, None], tr, 1.0)


def eval_phase(scene, med_idx, wo, wi):
    """HG phase value between world directions (reference:
    Src/medium.h:86-90, 29-34). ``wo`` = current ray direction."""
    med = gather_medium(scene, med_idx)
    return hg_phase(dot(wo, wi), med["g"])[:, None] * jnp.ones((1, 3))


def default_max_steps(tables, safety=3.0, floor=64, cap=4096):
    """Principled tracking-step bound: majorant * grid-bbox diagonal is the
    expected null-collision step count to cross the whole volume, so
    ``safety`` times that (plus slack) makes bound-truncation (which biases
    dark) astronomically unlikely (SURVEY.md §7 "hard parts"). Host-side,
    from concrete tables."""
    import numpy as np

    med_type = np.asarray(tables.med_type)
    het = med_type == MED_HETEROGENEOUS
    if not het.any():
        return floor
    maj = float(np.asarray(tables.med_majorant)[het].max())
    diag = float(
        np.linalg.norm(
            np.asarray(tables.grid_max) - np.asarray(tables.grid_min)
        )
    )
    return int(min(cap, max(floor, safety * maj * diag + 32)))
