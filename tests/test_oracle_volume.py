"""Independent scalar oracle for HETEROGENEOUS VolumePathTracing.

The supergrid delta-tracking machinery (media.py `_majorant_segments` /
`_sample_heterogeneous`) is the most intricate code in the framework; its
existing gates are closed-form constant-grid checks, XLA<->Pallas
draw-for-draw parity, and self-goldens. This oracle closes the remaining
hole: a from-scratch scalar reimplementation of the WHOLE pipeline —
integer-walk DDA majorant segments, optical-depth inversion, spectral-MIS
channel selection, weighted delta tracking, HG/isotropic phase resampling,
emissive-sphere Le — reproduces the framework's render allclose at matched
(seed, pixel, sample, site) draws, so a pdf-convention or weighting error
SHARED by both device paths would now be caught.

All arithmetic is kept in float32 (python-float promotion avoided) so the
oracle takes the same branches at the framework's discrete decisions
(block walks, escape tests, scatter picks).
"""

import numpy as np

from xraytracer.camera import PinholeCamera
from xraytracer.constants import RAY_EPS
from xraytracer.integrators import make_volume_integrator
from xraytracer.math import from_rows
from xraytracer.renderer import render
from xraytracer.scene.builder import SceneBuilder, scene_statics

from test_oracle import SITES_PER_BOUNCE, Oracle, path_key, u1, u2

W, H = 12, 9
SPP = 3
F = np.float32
_DDA_SEGMENTS = 24
_SITE_MEDIUM = 16
_SITES_PER_STEP = 4


def _f32(x):
    return np.asarray(x, np.float32)


class HetVolumeOracle(Oracle):
    def __init__(self, tables, cam_kwargs, width, height, seed=0):
        super().__init__(tables, cam_kwargs, width, height, seed)
        t = tables
        self.grid = _f32(t.grid_density)
        self.gmin = _f32(t.grid_min)
        self.gmax = _f32(t.grid_max)
        self.super = _f32(t.grid_super).reshape(
            tuple(int(v) for v in np.asarray(t.grid_super_nb))
        )
        self.super_bs = _f32(t.grid_super_bsize)
        mrow = int(np.flatnonzero(np.asarray(t.med_type) >= 0)[0])
        self.sa = _f32(t.med_sigma_a)[mrow]
        self.ss = _f32(t.med_sigma_s)[mrow]
        self.dm = F(np.asarray(t.med_density_mult)[mrow])
        self.majorant = F(np.asarray(t.med_majorant)[mrow])
        self.g = F(np.asarray(t.med_g)[mrow])
        self.box_lo = _f32(t.box_min)[0]
        self.box_hi = _f32(t.box_max)[0]
        sph = np.flatnonzero(np.asarray(t.sph_obj) >= 0)
        self.sph_c = _f32(t.sph_center)[sph]
        self.sph_r = _f32(t.sph_radius)[sph]
        self.sph_lrow = np.asarray(t.obj_light)[np.asarray(t.sph_obj)[sph]]

    # --- geometry (float32, mirrors geometry/intersect.py) ----------------
    def _intersect(self, o, d):
        """Nearest among emissive spheres and the medium box. Returns
        (t, t1, lrow, ns) with lrow -1 for the box."""
        t_best, lrow, ns = F(np.inf), -1, None
        a = F(d @ d)
        for c, r, lr in zip(self.sph_c, self.sph_r, self.sph_lrow):
            e = o - c
            b = F(2.0) * F(d @ e)
            cq = F(e @ e) - r * r
            disc = b * b - F(4.0) * a * cq
            if disc < 0:
                continue
            sq = np.sqrt(disc)
            q = -F(0.5) * (b + sq) if b > 0 else -F(0.5) * (b - sq)
            x0 = q / a
            x1 = x0 if q == 0 else cq / q
            lo, hi = min(x0, x1), max(x0, x1)
            t = lo if lo > 0 else hi
            if t > 0 and t < t_best:
                t_best, lrow = t, int(lr)
                p = o + t * d
                nvec = p - c
                ns = nvec / F(np.linalg.norm(nvec))
        # box slab, entry clamped to 0 (geometry.intersect_boxes)
        eps = F(1e-12)
        b0, b1 = F(-np.inf), F(np.inf)
        for k in range(3):
            dk = d[k] if abs(d[k]) >= eps else (eps if d[k] >= 0 else eps)
            dk = d[k] if abs(d[k]) >= eps else eps
            ta = (self.box_lo[k] - o[k]) / dk
            tb = (self.box_hi[k] - o[k]) / dk
            b0 = max(b0, min(ta, tb))
            b1 = min(b1, max(ta, tb))
        box_ok = (b0 <= b1) and (b1 > 0)
        b0 = max(b0, F(0.0))
        if box_ok and b0 < t_best:
            return b0, b1, -1, None          # box wins
        if t_best < np.inf:
            return t_best, F(np.inf), lrow, ns
        return F(np.inf), F(np.inf), -2, None  # miss

    # --- density / majorants (media.py parity, float32) -------------------
    def _density(self, p):
        res = np.array(self.grid.shape)
        for k in range(3):
            if p[k] < self.gmin[k] or p[k] > self.gmax[k]:
                return F(0.0)
        ext = self.gmax - self.gmin
        ext = np.where(ext == 0, F(1.0), ext)
        x = (p - self.gmin) / ext * _f32(res - 1)
        x = np.clip(x, F(0.0), _f32(res - 1))
        i0 = np.floor(x).astype(int)
        f = x - _f32(i0)
        i1 = np.minimum(i0 + 1, res - 1)
        gq = self.grid

        def cr(ax, ay, az):
            return gq[ax, ay, az]

        v = F(0.0)
        for cx, wx in ((i0[0], 1 - f[0]), (i1[0], f[0])):
            for cy, wy in ((i0[1], 1 - f[1]), (i1[1], f[1])):
                for cz, wz in ((i0[2], 1 - f[2]), (i1[2], f[2])):
                    v = v + cr(cx, cy, cz) * F(wx) * F(wy) * F(wz)
        return F(v)

    def _dda(self, o, d, t0, t1):
        """media._majorant_segments, scalar float32."""
        res = _f32(self.grid.shape)
        ext = self.gmax - self.gmin
        scale = (res - 1) / np.where(ext == 0, F(1.0), ext)
        a = (o - self.gmin) * scale
        v = d * scale
        sig_t_max = F((self.sa + self.ss).max())
        t0f = t0 if np.isfinite(t0) else F(0.0)
        t1f = max(t1, t0f) if np.isfinite(t1) else t0f
        nb = _f32(self.super.shape)
        bs = self.super_bs
        b = np.clip(np.floor((a + t0f * v) / bs), F(0.0), nb - 1)
        sgn = np.where(v >= 0, F(1.0), F(-1.0))
        seg_t, seg_m = [], []
        t_cur = t0f
        for _ in range(_DDA_SEGMENTS):
            bm = self.super[int(b[0]), int(b[1]), int(b[2])]
            m_loc = bm * self.dm * sig_t_max
            lo = b * bs
            hi = (b + 1) * bs
            v_safe = np.where(np.abs(v) < F(1e-20), F(1e-20), v)
            t_exit = np.where(
                v > F(1e-20), (hi - a) / v_safe,
                np.where(v < F(-1e-20), (lo - a) / v_safe, F(np.inf)),
            )
            t_hi = t_exit.min()
            ax = int(t_exit.argmin())
            seg_t.append(t_cur)
            seg_m.append(m_loc if t_cur < t1f else F(0.0))
            step = np.zeros(3, np.float32)
            step[ax] = sgn[ax]
            b = np.clip(b + step, F(0.0), nb - 1)
            t_cur = min(max(t_hi, t_cur), t1f)
        t_tail = min(t_cur, t1f)
        seg_t.append(t_tail)
        seg_m.append(self.majorant if t_tail < t1f else F(0.0))
        edges = [F(0.0)]
        for k in range(_DDA_SEGMENTS + 1):
            end = t1f if k == _DDA_SEGMENTS else seg_t[k + 1]
            edges.append(F(edges[-1] + seg_m[k] * max(end - seg_t[k], F(0.0))))
        return seg_t, seg_m, edges, t1f

    @staticmethod
    def _tau_to_t(seg_t, seg_m, edges, tau):
        k = sum(1 for e in edges[:-1] if e <= tau) - 1
        k = min(max(k, 0), len(seg_m) - 1)
        m = seg_m[k]
        t = seg_t[k] + (tau - edges[k]) / (m if m > 0 else F(1.0))
        return F(t), m

    @staticmethod
    def _pick_channel(w, u):
        s = F(w[0] + w[1] + w[2])
        if s > 0:
            pmf = w / s
        else:
            pmf = np.full(3, F(1.0 / 3.0))
        c1 = pmf[0]
        c2 = F(pmf[0] + pmf[1])
        x = int(0.0 < u) + int(c1 < u) + int(c2 < u)
        return max(x, 1) - 1, pmf

    def _track(self, o, d, t0, t1, path_thr, key, site, max_steps):
        """media._sample_heterogeneous, scalar float32. Returns
        (pos, scattered, weight, scat_step)."""
        seg_t, seg_m, edges, t1f = self._dda(o, d, t0, t1)
        tau_total = F(edges[-1] - F(RAY_EPS) * self.majorant)
        sigma_a = self.sa * (self._density(o + t0 * d) * self.dm)
        _, m_entry = self._tau_to_t(seg_t, seg_m, edges, F(0.0))
        m_prev = max(m_entry, F(0.0))
        w = np.ones(3, np.float32)
        tau = F(0.0)
        pos = o + (t1 + F(RAY_EPS)) * d
        scat_step = 0
        for step in range(max_steps):
            sb = site + step * _SITES_PER_STEP
            u_wl = F(u1(key, sb + 0))
            u_dist = F(u1(key, sb + 1))
            u_ev = F(u1(key, sb + 2))
            m_prev_s = m_prev if m_prev > 0 else F(1.0)
            alb = np.maximum((m_prev - sigma_a) / m_prev_s, F(0.0))
            ch, pmf = self._pick_channel(
                _f32(path_thr) * w * alb, u_wl
            )
            dtau = F(-np.log(max(F(1.0) - u_dist, F(1e-38))))
            tau_new = F(tau + dtau)
            if tau_new > tau_total:  # escape
                tr = F(np.exp(-(tau_total - tau)))
                pdf = F(pmf.sum() * tr)
                w = w * tr / (pdf if pdf != 0 else F(1.0))
                return pos, False, self._nan_guard(w), scat_step
            t_new, m_loc = self._tau_to_t(seg_t, seg_m, edges, tau_new)
            m_safe = m_loc if m_loc > 0 else F(1.0)
            dens = self._density(o + t_new * d) * self.dm
            sig_s = self.ss * dens
            sig_a_new = self.sa * dens
            sig_n = np.maximum(m_loc - sig_a_new - sig_s, F(0.0))
            denom = np.where(sig_s + sig_n == 0, F(1.0), sig_s + sig_n)
            p_s = sig_s / denom
            p_n = sig_n / denom
            tr_s = F(np.exp(-dtau))
            if u_ev < p_s[ch]:  # in-scatter
                pdf = F((pmf * m_safe * tr_s * p_s).sum())
                w = w * tr_s * sig_s / (pdf if pdf != 0 else F(1.0))
                return (o + t_new * d, True, self._nan_guard(w), step)
            pdf = F((pmf * m_safe * tr_s * p_n).sum())
            w = w * tr_s * sig_n / (pdf if pdf != 0 else F(1.0))
            tau, m_prev, sigma_a = tau_new, m_loc, sig_a_new
        return pos, False, np.zeros(3, np.float32), scat_step  # exhausted

    @staticmethod
    def _nan_guard(w):
        return np.zeros(3, np.float32) if np.isnan(w).any() else w

    @staticmethod
    def _duff(n):
        sign = F(1.0) if n[2] >= 0 else F(-1.0)
        a = F(-1.0) / (sign + n[2])
        c = n[0] * n[1] * a
        t = np.array([1 + sign * n[0] * n[0] * a, sign * c, -sign * n[0]], F)
        b = np.array([c, sign + n[1] * n[1] * a, -n[1]], F)
        return t, b

    def _phase_dir(self, d, key, site, scat_step):
        up1, up2 = u2(key, site + scat_step * _SITES_PER_STEP + 3)
        up1, up2 = F(up1), F(up2)
        if abs(float(self.g)) < 1e-3:
            cos_t = F(2.0) * up1 - F(1.0)
        else:
            g = self.g
            sqr = (1 - g * g) / (1 - g + 2 * g * up1)
            cos_t = (1 + g * g - sqr * sqr) / (2 * g)
        sin_t = F(np.sqrt(max(F(1.0) - cos_t * cos_t, F(0.0))))
        phi = F(2.0 * np.pi) * up2
        lx = F(np.cos(phi)) * sin_t
        lz = F(np.sin(phi)) * sin_t
        t, b = self._duff(d)
        nd = lx * t + cos_t * d + lz * b
        return nd

    # --- the VolumePathTracing iteration loop (volume.py parity) ----------
    def vpt(self, px, py, sample, max_depth, max_steps):
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        o, d = _f32(o), _f32(d)
        d = d / F(np.linalg.norm(d))
        radiance = np.zeros(3, np.float32)
        thr = np.ones(3, np.float32)
        depth = 0
        for it in range(2 * max_depth + 2):
            site = it * SITES_PER_BOUNCE
            if depth >= max_depth:
                break
            t, t1, lrow, ns = self._intersect(o, d)
            if lrow == -2:
                break  # miss: black background
            u_rr = F(u1(key, site + 0))
            if depth > 0:
                rr = min(F(thr.mean()), F(1.0))
                if u_rr >= rr:
                    break
                thr = thr / max(rr, F(1e-12))
            if lrow >= 0:  # emissive sphere, one-sided (every depth: no NEE)
                if F(-(d @ ns)) > 0:
                    radiance = radiance + thr * _f32(self.al_le[lrow])
                break
            # the box: sample the medium over [t, t1]
            pos, scattered, w, scat_step = self._track(
                o, d, t, t1, thr, key, site + _SITE_MEDIUM, max_steps
            )
            if scattered:
                d = self._phase_dir(d, key, site + _SITE_MEDIUM, scat_step)
                d = _f32(d)
            o = _f32(pos)
            thr = thr * w
            depth += int(scattered)
            if not (thr > 0).any():
                break
        return radiance


def _scene():
    """Tiny heterogeneous cloud box + one emissive sphere light."""
    rng = np.random.default_rng(7)
    grid = (rng.uniform(0.1, 1.0, (5, 5, 5)) ** 2).astype(np.float32)
    b = SceneBuilder()
    b.set_density_grid(grid, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    b.add_heterogeneous_medium(0.0, (0.05, 0.08, 0.1), (1.4, 1.2, 1.0))
    b.add_sphere_light((0.0, 1.8, 0.0), 0.9, (12.0, 10.0, 8.0))
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.3, 3.5, 1)
    return b.build(), dict(c2w=c2w, fov_deg=55.0)


def test_het_vpt_matches_oracle():
    """Heterogeneous VolumePathTracing (supergrid delta tracking, spectral
    MIS, phase resampling, emissive-sphere Le) against the independent
    scalar oracle at matched seeds."""
    tables, camk = _scene()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **camk)
    max_depth, max_steps = 3, 64
    integ = make_volume_integrator(
        tables, statics, max_depth=max_depth, nee=False,
        max_steps=max_steps,
    )
    r = render(tables, cam, integ, W, H, SPP, seed=0)
    oracle = HetVolumeOracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.vpt(px, py, s, max_depth, max_steps)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=2e-3, atol=3e-4)
    assert expect.mean() > 1e-3  # medium actually lit


# --- NEE variant: cone light sampling + ratio-tracked transmittance ---------

class HetVolumeNEEOracle(HetVolumeOracle):
    """VolumePathTracingNEE (reference: Src/integrator.h:481-636) on top of
    the tracking oracle: at every scatter vertex, uniform light pick
    (site P), PBRT cone sample of the sphere light (site P+1), isVisible =
    one intersect + ratio-tracked transmittance over the medium span
    (sites P+16+step), phase-function weighting; emitter hits add Le at
    depth 0 only. P = max(8192, 16 + max_steps*4) (volume._nee_site_layout).
    """

    def _transmittance(self, p1, p2, key, site, max_steps):
        """media.segment_transmittance het branch, scalar float32."""
        dv = p2 - p1
        dist = F(np.linalg.norm(dv))
        if dist == 0:
            return np.ones(3, np.float32)
        d = dv / dist
        seg_t, seg_m, edges, _ = self._dda(p1, d, F(0.0), dist)
        tau_total = F(edges[-1])
        tr = np.ones(3, np.float32)
        tau = F(0.0)
        for step in range(max_steps):
            u = F(u1(key, site + step))
            tau_new = F(tau - np.log(max(F(1.0) - u, F(1e-38))))
            if tau_new > tau_total:
                return tr
            t_new, m_loc = self._tau_to_t(seg_t, seg_m, edges, tau_new)
            dens = self._density(p1 + t_new * d) * self.dm
            m_safe = m_loc if m_loc > 0 else F(1.0)
            sig_n = np.maximum(m_loc - (self.sa + self.ss) * dens, F(0.0))
            tr = tr * sig_n / m_safe
            tau = tau_new
        return np.zeros(3, np.float32)  # exhausted -> never biased bright

    def _cone_sample(self, mp, li, lu, lv):
        """lights.sample_area_light sphere default (PBRT cone; reference:
        Src/light.h:160-198). Returns (wi, pdf, le_front)."""
        c = _f32(np.asarray(self.al_v0))  # unused; sphere tables below
        center = self._al_center[li]
        r = self._al_radius[li]
        dz = center - mp
        len2 = F(dz @ dz)
        ln = F(np.sqrt(len2))
        u = -dz / (ln if ln != 0 else F(1.0))
        t, b = self._duff(u)
        sin_tm2 = r * r / (len2 if len2 != 0 else F(1.0))
        sin_tm = F(np.sqrt(sin_tm2))
        cos_tm = F(np.sqrt(max(F(0.0), F(1.0) - sin_tm2)))
        cos_t = F(1.0) + (cos_tm - F(1.0)) * F(lu)
        sin_t2 = F(1.0) - cos_t * cos_t
        s_tm = sin_tm if sin_tm != 0 else F(1.0)
        s_tm2 = sin_tm2 if sin_tm2 != 0 else F(1.0)
        cos_a = sin_t2 / s_tm + cos_t * F(
            np.sqrt(max(F(0.0), F(1.0) - sin_t2 / s_tm2))
        )
        sin_a = F(np.sqrt(max(F(0.0), F(1.0) - cos_a * cos_a)))
        phi = F(2.0 * np.pi) * F(lv)
        ns = (F(np.cos(phi)) * sin_a * t + F(np.sin(phi)) * sin_a * b
              + cos_a * u)
        p = center + ns * r
        dvec = p - mp
        t_max = F(np.linalg.norm(dvec))
        front = F(dvec @ ns) < 0
        pdf = F(1.0) / (F(2.0 * np.pi) * max(F(1.0) - cos_tm, F(1e-12)))
        wi = dvec / (t_max if t_max != 0 else F(1.0))
        return wi, pdf, front

    def vpt_nee(self, px, py, sample, max_depth, max_steps):
        pick_site = max(8192, _SITE_MEDIUM + max_steps * _SITES_PER_STEP)
        light_site, tr_site = pick_site + 1, pick_site + 16
        self._al_center = _f32(np.asarray(self._tables.al_center))
        self._al_radius = _f32(np.asarray(self._tables.al_radius))
        n_lights = self.n_lights
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        o, d = _f32(o), _f32(d)
        d = d / F(np.linalg.norm(d))
        radiance = np.zeros(3, np.float32)
        thr = np.ones(3, np.float32)
        depth = 0
        for it in range(2 * max_depth + 2):
            site = it * SITES_PER_BOUNCE
            if depth >= max_depth:
                break
            t, t1, lrow, ns = self._intersect(o, d)
            if lrow == -2:
                break
            u_rr = F(u1(key, site + 0))
            if depth > 0:
                rr = min(F(thr.mean()), F(1.0))
                if u_rr >= rr:
                    break
                thr = thr / max(rr, F(1e-12))
            if lrow >= 0:
                if depth == 0 and F(-(d @ ns)) > 0:  # Le at depth 0 only
                    radiance = radiance + thr * _f32(self.al_le[lrow])
                break
            pos, scattered, w, scat_step = self._track(
                o, d, t, t1, thr, key, site + _SITE_MEDIUM, max_steps
            )
            if scattered:
                # NEE at the scatter vertex
                u_pick = u1(key, site + pick_site)
                li = min(int(u_pick * n_lights), n_lights - 1)
                lu, lv = u2(key, site + light_site)
                wi, cone_pdf, front = self._cone_sample(pos, li, lu, lv)
                pdf = F(cone_pdf / n_lights) * F(1.0)
                pdf = cone_pdf * F(1.0 / n_lights)
                if pdf > 0:
                    st, st1, slrow, _ = self._intersect(pos, wi)
                    if slrow == -1:  # medium box: ratio-tracked span
                        p1 = pos + st * wi
                        p2 = pos + (st1 if np.isfinite(st1) else st) * wi
                        tr = self._transmittance(
                            p1, p2, key, site + tr_site, max_steps
                        )
                    else:
                        tr = np.ones(3, np.float32)
                    le = (_f32(self.al_le[li]) if front
                          else np.zeros(3, np.float32))
                    f = F(1.0 / (4.0 * np.pi))  # g = 0: isotropic phase
                    radiance = radiance + thr * w * tr * f * le / pdf
                d = self._phase_dir(d, key, site + _SITE_MEDIUM, scat_step)
                d = _f32(d)
            o = _f32(pos)
            thr = thr * w
            depth += int(scattered)
            if not (thr > 0).any():
                break
        return radiance


def test_het_vpt_nee_matches_oracle():
    """VolumePathTracingNEE (cone light sampling, isVisible transmittance,
    phase weighting) against the independent scalar oracle — the reference
    nee workload's estimator, fully oracled."""
    tables, camk = _scene()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **camk)
    max_depth, max_steps = 3, 64
    integ = make_volume_integrator(
        tables, statics, max_depth=max_depth, nee=True,
        max_steps=max_steps,
    )
    r = render(tables, cam, integ, W, H, SPP, seed=0)
    oracle = HetVolumeNEEOracle(tables, camk, W, H, seed=0)
    oracle._tables = tables
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.vpt_nee(
                    px, py, s, max_depth, max_steps
                )
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=2e-3, atol=3e-4)
    # NEE lights up most medium pixels, not just lucky chains
    assert (expect.sum(-1) > 0).mean() > 0.3
