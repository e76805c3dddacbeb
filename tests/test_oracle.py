"""Independent numpy oracle vs. the JAX renderer at matched seeds.

The BASELINE.md correctness gate: a from-scratch scalar/numpy
re-implementation of the render pipeline (RNG, camera, intersection, light
sampling, shading) reproduces the framework's images allclose at the same
(seed, pixel, sample, site) random draws. This catches systematic errors
that a same-code regression test cannot — everything here is written
directly from the math, sharing no code with xraytracer except the
constants.
"""

import numpy as np
import jax.numpy as jnp

from xraytracer.camera import PinholeCamera
from xraytracer.constants import K_EPS, SHADOW_BIAS
from xraytracer.integrators import make_direct_integrator, make_normal_integrator
from xraytracer.renderer import CAMERA_SITE, render
from xraytracer.scene.builder import SceneBuilder, scene_statics
from xraytracer.scene.presets import build_cornell_box, cornell_camera

W, H = 16, 12
SPP = 2

# --- independent PCG RNG (pure-int, mirrors the published hash) -----------
MASK = 0xFFFFFFFF


def pcg(x):
    x = (x * 747796405 + 2891336453) & MASK
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK
    return (word >> 22) ^ word


def path_key(seed, pixel, sample):
    s = pcg((pcg(seed & MASK) + pixel) & MASK)
    return pcg((s + sample) & MASK)


def u1(key, site):
    x = pcg((key + site * 0x9E3779B9) & MASK)
    return float(x >> 8) * (1.0 / (1 << 24))


def u2(key, site):
    x1 = pcg((key + site * 0x9E3779B9) & MASK)
    x2 = pcg(x1)
    s = 1.0 / (1 << 24)
    return float(x1 >> 8) * s, float(x2 >> 8) * s


# --- scalar geometry -------------------------------------------------------

def ray_triangle(o, d, v0, e1, e2):
    """Classic Möller-Trumbore; returns (t, hit)."""
    pvec = np.cross(d, e2)
    det = float(e1 @ pvec)
    if abs(det) < K_EPS:
        return np.inf, False
    inv = 1.0 / det
    tvec = o - v0
    u = float(tvec @ pvec) * inv
    if u < 0 or u > 1:
        return np.inf, False
    qvec = np.cross(tvec, e1)
    v = float(d @ qvec) * inv
    if v < 0 or u + v > 1:
        return np.inf, False
    t = float(e2 @ qvec) * inv
    return (t, True) if t > K_EPS else (np.inf, False)


class Oracle:
    def __init__(self, tables, cam_kwargs, width, height, seed=0):
        t = tables
        self.v0 = np.asarray(t.tri_v0, np.float64)
        self.e1 = np.asarray(t.tri_e1, np.float64)
        self.e2 = np.asarray(t.tri_e2, np.float64)
        self.obj = np.asarray(t.tri_obj)
        self.obj_mat = np.asarray(t.obj_mat)
        self.obj_light = np.asarray(t.obj_light)
        self.mat_albedo = np.asarray(t.mat_albedo, np.float64)
        self.al_le = np.asarray(t.al_le, np.float64)
        self.al_v0 = np.asarray(t.al_v0, np.float64)
        self.al_e1 = np.asarray(t.al_e1, np.float64)
        self.al_e2 = np.asarray(t.al_e2, np.float64)
        self.al_ng = np.asarray(t.al_ng, np.float64)
        self.n_lights = int((np.asarray(t.al_type) >= 0).sum())
        self.c2w = np.asarray(cam_kwargs["c2w"], np.float64)
        self.scale = np.tan(0.5 * np.deg2rad(cam_kwargs.get("fov_deg", 90.0)))
        self.aspect = width / height
        self.width, self.height, self.seed = width, height, seed

    def camera_ray(self, px, py, key):
        ux, uy = u2(key, CAMERA_SITE)
        su = (px + ux) / self.width
        sv = (py + uy) / self.height
        d_local = np.array(
            [
                (2 * su - 1) * self.scale,
                (1 - 2 * sv) * self.scale / self.aspect,
                -1.0,
            ]
        )
        d = d_local @ self.c2w[:3, :3]  # row-vector convention
        d /= np.linalg.norm(d)
        return self.c2w[3, :3].copy(), d

    def intersect(self, o, d):
        best_t, best_i = np.inf, -1
        for i in range(len(self.v0)):
            if self.obj[i] < 0:
                continue
            t, hit = ray_triangle(o, d, self.v0[i], self.e1[i], self.e2[i])
            if hit and t < best_t:
                best_t, best_i = t, i
        return best_t, best_i

    def occluded(self, o, d, t_max):
        for i in range(len(self.v0)):
            oi = self.obj[i]
            if oi < 0 or self.obj_light[oi] >= 0:  # emitters never block
                continue
            t, hit = ray_triangle(o, d, self.v0[i], self.e1[i], self.e2[i])
            if hit and t < t_max:
                return True
        return False

    def direct(self, px, py, sample):
        """The DirectIntegrator (reference: Src/integrator.h:76-120)."""
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        t, i = self.intersect(o, d)
        if i < 0:
            return np.full(3, 0.18)
        oi = self.obj[i]
        lrow = self.obj_light[oi]
        ng = np.cross(self.e1[i], self.e2[i])
        ng /= np.linalg.norm(ng)
        pos = o + t * d
        if lrow >= 0:  # emitter: one-sided Le
            return self.al_le[lrow] if (-d) @ ng > 0 else np.zeros(3)
        radiance = np.zeros(3)
        albedo = self.mat_albedo[self.obj_mat[oi]]
        for li in range(self.n_lights):
            ux, uy = u2(key, 16 + li)
            # quad light bilinear sample (the only light type in Cornell)
            p = self.al_v0[li] + ux * self.al_e1[li] + uy * self.al_e2[li]
            dvec = p - pos
            tmax = np.linalg.norm(dvec)
            ddn = dvec @ self.al_ng[li]
            if ddn >= 0:
                continue  # backfacing -> Le 0, pdf irrelevant
            pdf = tmax ** 3 / abs(ddn)
            wi = dvec / tmax
            so = pos + SHADOW_BIAS * ng
            vis = not self.occluded(so, wi, tmax - SHADOW_BIAS)
            cos = max(0.0, ng @ wi)
            fr = albedo / np.pi
            if vis:
                radiance += fr * self.al_le[li] * cos / pdf
        return radiance

    def normal_viz(self, px, py, sample):
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        t, i = self.intersect(o, d)
        if i < 0:
            return np.zeros(3)
        # Cornell uses flat normals == geometric normal
        ng = np.cross(self.e1[i], self.e2[i])
        ng /= np.linalg.norm(ng)
        return 0.5 * (ng + 1.0)


def test_direct_matches_oracle():
    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camk = cornell_camera()
    cam = PinholeCamera.make(W / H, **camk)
    r = render(
        tables, cam, make_direct_integrator(tables, statics), W, H, SPP, seed=0
    )
    oracle = Oracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.direct(px, py, s)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=5e-4, atol=5e-5)


def test_normal_matches_oracle():
    tables = build_cornell_box().build()
    camk = cornell_camera()
    cam = PinholeCamera.make(W / H, **camk)
    r = render(tables, cam, make_normal_integrator(tables), W, H, 1, seed=0)
    oracle = Oracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            expect[py, px] = oracle.normal_viz(px, py, 0)
    np.testing.assert_allclose(r.image, expect, atol=1e-4)


# --- GI oracle (depth 2, cosine sampling) ----------------------------------

def _duff_onb(n):
    """Duff et al. branchless ONB, written from the published formulas."""
    sign = 1.0 if n[2] >= 0.0 else -1.0
    a = -1.0 / (sign + n[2])
    c = n[0] * n[1] * a
    t = np.array([1.0 + sign * n[0] * n[0] * a, sign * c, -sign * n[0]])
    b = np.array([c, sign + n[1] * n[1] * a, -n[1]])
    return t, b


SITES_PER_BOUNCE = 1 << 16


class GIOracle(Oracle):
    """Scalar GI path tracer (reference: Src/integrator.h:198-291) at the
    framework's exact (seed, pixel, sample, site) draws: RR site 0, BSDF
    2-uniform site 1, lobe site 2, light i at site 16+i; cosine-weighted
    Lambert sampling; NEE with Le only at depth 0."""

    def gi(self, px, py, sample, max_depth=2, nee=True):
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        radiance = np.zeros(3)
        throughput = np.ones(3)
        for depth in range(max_depth):
            base = depth * SITES_PER_BOUNCE
            t, i = self.intersect(o, d)
            if i < 0:
                break  # black background
            # RR before the emitter check (Src/integrator.h:224-231)
            u_rr = u1(key, base + 0)
            if depth > 0:
                rr = min(float(throughput.mean()), 1.0)
                if u_rr >= rr:
                    break
                throughput = throughput / rr
            oi = self.obj[i]
            lrow = self.obj_light[oi]
            ng = np.cross(self.e1[i], self.e2[i])
            ng /= np.linalg.norm(ng)
            pos = o + t * d
            if lrow >= 0:
                # one-sided Le: depth 0 only under NEE, every depth without
                # (Src/integrator.h:158-166 vs 236-244)
                if (nee is False or depth == 0) and (-d) @ ng > 0:
                    radiance += throughput * self.al_le[lrow]
                break
            albedo = self.mat_albedo[self.obj_mat[oi]]
            # NEE over all lights (site 16+i)
            for li in range(self.n_lights if nee else 0):
                ux, uy = u2(key, base + 16 + li)
                p = self.al_v0[li] + ux * self.al_e1[li] + uy * self.al_e2[li]
                dvec = p - pos
                tmax = np.linalg.norm(dvec)
                ddn = dvec @ self.al_ng[li]
                if ddn >= 0:
                    continue
                pdf = tmax ** 3 / abs(ddn)
                wi = dvec / tmax
                # eval_bsdf: both directions above the shading normal
                if (-d) @ ng <= 0 or wi @ ng <= 0:
                    continue
                so = pos + SHADOW_BIAS * ng
                if not self.occluded(so, wi, tmax - SHADOW_BIAS):
                    cos = max(0.0, ng @ wi)
                    radiance += throughput * (albedo / np.pi) * self.al_le[li] * cos / pdf
            # cosine-weighted bounce (site 1; lobe site 2 unused for Lambert)
            bx, by = u2(key, base + 1)
            u1(key, base + 2)  # lobe draw consumed
            r = np.sqrt(bx)
            phi = 2 * np.pi * by
            wl = np.array([r * np.cos(phi), np.sqrt(max(0.0, 1.0 - bx)),
                           r * np.sin(phi)])
            tg, bt = _duff_onb(ng)  # frame from shading normal (== ng, flat)
            wi = wl[0] * tg + wl[1] * ng + wl[2] * bt
            throughput = throughput * albedo  # fr*cos/pdf = albedo
            sign = -np.sign(d @ ng)
            o = pos + sign * SHADOW_BIAS * ng
            d = wi
        return radiance


def test_gi_depth2_matches_oracle():
    """Depth-2 GI (NEE + RR + cosine bounce) against the independent scalar
    oracle at matched seeds — promotes the GI golden from a regression gate
    to a correctness gate (round-1 VERDICT item 7)."""
    from xraytracer.integrators import make_path_integrator

    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camk = cornell_camera()
    cam = PinholeCamera.make(W / H, **camk)
    r = render(
        tables, cam,
        make_path_integrator(tables, statics, 2, nee=True, cosine_sampling=True),
        W, H, SPP, seed=0,
    )
    oracle = GIOracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.gi(px, py, s)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=1e-3, atol=2e-4)


def test_indirect_depth3_matches_oracle():
    """IndirectIntegrator (BSDF-only, Le at every depth) against the scalar
    oracle at depth 3 — the last surface integrator whose only prior gate
    was depth-shifted consistency against GI."""
    from xraytracer.integrators import make_path_integrator

    tables = build_cornell_box().build()
    statics = scene_statics(tables)
    camk = cornell_camera()
    cam = PinholeCamera.make(W / H, **camk)
    r = render(
        tables, cam,
        make_path_integrator(tables, statics, 3, nee=False,
                             cosine_sampling=True),
        W, H, SPP, seed=0,
    )
    oracle = GIOracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.gi(px, py, s, max_depth=3, nee=False)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=1e-3, atol=2e-4)
    assert expect.mean() > 1e-3


# --- homogeneous VPT oracle -------------------------------------------------

class VPTOracle(Oracle):
    """Scalar VolumePathTracing (reference: Src/integrator.h:401-478) for an
    ACHROMATIC homogeneous box medium + emissive quad, at the framework's
    exact draws: per iteration, RR at site 0, medium wavelength/distance/
    phase at sites 16/17/18; depth++ only on real scatter; no NEE."""

    def __init__(self, tables, cam_kwargs, width, height, seed=0):
        super().__init__(tables, cam_kwargs, width, height, seed=seed)
        t = tables
        self.box_min = np.asarray(t.box_min, np.float64)[0]
        self.box_max = np.asarray(t.box_max, np.float64)[0]
        self.sigma_a = np.asarray(t.med_sigma_a, np.float64)[0]
        self.sigma_s = np.asarray(t.med_sigma_s, np.float64)[0]

    def _box(self, o, d):
        d_safe = np.where(np.abs(d) < 1e-12, 1e-12, d)
        inv = 1.0 / d_safe
        ta = (self.box_min - o) * inv
        tb = (self.box_max - o) * inv
        t0 = np.minimum(ta, tb).max()
        t1 = np.maximum(ta, tb).min()
        if t0 <= t1 and t1 > 0.0:
            return max(t0, 0.0), t1, True
        return np.inf, np.inf, False

    def vpt(self, px, py, sample, max_depth=3):
        from xraytracer.constants import RAY_EPS

        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        radiance = np.zeros(3)
        throughput = np.ones(3)
        depth = 0
        sig_t = self.sigma_a + self.sigma_s  # achromatic: all channels equal
        for it in range(2 * max_depth + 2):
            if depth >= max_depth:
                break
            base = it * SITES_PER_BOUNCE
            tt, ti = self.intersect(o, d)          # light triangles
            b0, b1, bhit = self._box(o, d)
            if not (ti >= 0 or bhit):
                break                               # miss -> black
            tri_wins = ti >= 0 and tt < b0
            u_rr = u1(key, base + 0)
            if depth > 0:
                rr = min(float(throughput.mean()), 1.0)
                if u_rr >= rr:
                    break
                throughput = throughput / rr
            if tri_wins:
                lrow = self.obj_light[self.obj[ti]]
                if lrow >= 0:
                    ng = np.cross(self.e1[ti], self.e2[ti])
                    ng /= np.linalg.norm(ng)
                    if (-d) @ ng > 0:               # one-sided
                        radiance += throughput * self.al_le[lrow]
                break                               # emitter (or surface) ends
            # medium sampling (achromatic; sites 16..18)
            u1(key, base + 16)                     # wavelength draw consumed
            u_dist = u1(key, base + 17)
            sx, sy = u2(key, base + 18)
            t = -np.log(max(1.0 - u_dist, 1e-38)) / sig_t[0]
            dist = b1 - b0
            if t > dist - RAY_EPS:                  # escape
                o = o + (b1 + RAY_EPS) * d
                continue
            pos = o + (b0 + t) * d
            # isotropic phase (g=0): cos = 2u-1, frame +Y = current dir
            ct = 2.0 * sx - 1.0
            st = np.sqrt(max(0.0, 1.0 - ct * ct))
            phi = 2.0 * np.pi * sy
            wl = np.array([np.cos(phi) * st, ct, np.sin(phi) * st])
            tg, bt = _duff_onb(d)
            wi = wl[0] * tg + wl[1] * d + wl[2] * bt
            throughput = throughput * (self.sigma_s / sig_t)
            o, d = pos, wi
            depth += 1
        return radiance


def test_vpt_matches_oracle():
    """Homogeneous achromatic VolumePathTracing against the scalar oracle at
    matched seeds (round-1 VERDICT item 7's volume half)."""
    from xraytracer.integrators import make_volume_integrator
    from xraytracer.math import from_rows
    from xraytracer.scene.presets import build_vpt_scene

    tables = build_vpt_scene(variant="achromatic").build()
    statics = scene_statics(tables)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 5.0, 1)
    fov = 2.0 * 180.0 * np.arctan(1.0 / 3.0) / np.pi
    camk = dict(c2w=c2w, fov_deg=fov)
    cam = PinholeCamera.make(W / H, **camk)
    r = render(
        tables, cam,
        make_volume_integrator(tables, statics, 3, nee=False, max_steps=16),
        W, H, SPP, seed=0,
    )
    oracle = VPTOracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.vpt(px, py, s)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=1e-3, atol=2e-4)


# --- Whitted oracle (mirror + glass + delta lights) -------------------------

class WhittedOracle(Oracle):
    """Scalar Whitted tracer (reference: Src/integrator.h:294-398) at the
    framework's draws: the only consumed random number per bounce is the
    glass lobe pick at site base+2 (counter-based RNG — unused draws don't
    shift the stream). Mirrors the kept reference quirks: shadow bias 0.1
    with range t_max (not t_max - bias), NEE cos against the shading
    normal, sky on miss AND on depth overflow, re-origin at 0.001*ng
    flipped for transmission."""

    SKY = np.array([0.235294, 0.67451, 0.843137])

    def __init__(self, tables, cam_kwargs, width, height, seed=0):
        super().__init__(tables, cam_kwargs, width, height, seed)
        t = tables
        self.mat_type = np.asarray(t.mat_type)
        self.mat_ior = np.asarray(t.mat_ior, np.float64)
        self.dl_type = np.asarray(t.dl_type)
        self.dl_pos = np.asarray(t.dl_pos, np.float64)
        self.dl_dir = np.asarray(t.dl_dir, np.float64)
        self.dl_le = (np.asarray(t.dl_color, np.float64)
                      * np.asarray(t.dl_intensity, np.float64)[:, None])
        self.n_delta = int((self.dl_type >= 0).sum())

    def whitted(self, px, py, sample, max_depth=3):
        key = path_key(self.seed, py * self.width + px, sample)
        o, d = self.camera_ray(px, py, key)
        radiance = np.zeros(3)
        throughput = np.ones(3)
        for depth in range(max_depth + 1):
            base = depth * SITES_PER_BOUNCE
            t, i = self.intersect(o, d)
            if i < 0:
                return radiance + throughput * self.SKY
            oi = self.obj[i]
            mrow = self.obj_mat[oi]
            mtype = self.mat_type[mrow] if mrow >= 0 else -1
            ng = np.cross(self.e1[i], self.e2[i])
            ng /= np.linalg.norm(ng)
            ns = ng  # flat shading normals
            pos = o + t * d
            if mtype == 0:  # Lambert: delta-light NEE, terminate
                albedo = self.mat_albedo[mrow]
                if (-d) @ ns > 0:  # eval_bsdf needs wo above the surface
                    for li in range(self.n_delta):
                        if self.dl_type[li] == 0:  # point
                            dv = self.dl_pos[li] - pos
                            dist = np.linalg.norm(dv)
                            wi, t_max, pdf = dv / dist, dist, dist * dist
                        else:  # distant
                            wi = -self.dl_dir[li]
                            t_max, pdf = np.inf, 1.0
                        if wi @ ns <= 0:
                            continue  # eval_bsdf: wi below surface -> 0
                        so = pos + 0.1 * ng
                        if not self.occluded(so, wi, t_max):
                            cos = max(0.0, ns @ wi)
                            radiance += (throughput * (albedo / np.pi)
                                         * self.dl_le[li] * cos / pdf)
                return radiance
            if mtype < 1:
                return radiance  # no material: terminate, no sky
            albedo = self.mat_albedo[mrow]
            flip = False
            if mtype == 1:  # mirror
                d_new = d - 2.0 * (d @ ns) * ns
            else:  # glass (Fresnel one-sample pick at site base+2)
                ul = u1(key, base + 2)
                ior = float(self.mat_ior[mrow])
                cosi = np.clip(d @ ns, -1.0, 1.0)
                exiting = cosi > 0.0
                etai, etat = (ior, 1.0) if exiting else (1.0, ior)
                sint = etai / etat * np.sqrt(max(0.0, 1.0 - cosi * cosi))
                cost = np.sqrt(max(0.0, 1.0 - sint * sint))
                cosa = abs(cosi)
                if sint >= 1.0:
                    kr = 1.0
                else:
                    rs = (etat * cosa - etai * cost) / (etat * cosa + etai * cost)
                    rp = (etai * cosa - etat * cost) / (etai * cosa + etat * cost)
                    kr = 0.5 * (rs * rs + rp * rp)
                eta = etai / etat
                k = 1.0 - eta * eta * (1.0 - cosa * cosa)
                if ul < kr or k <= 0.0:
                    d_new = d - 2.0 * (d @ ns) * ns
                else:
                    nn = (1.0 if cosi < 0.0 else -1.0) * ns
                    d_new = eta * d + (eta * cosa - np.sqrt(k)) * nn
                    flip = True
            throughput = throughput * albedo
            sign = -np.sign(d @ ng)
            if flip:
                sign = -sign
            o = pos + sign * 0.001 * ng
            d = d_new
        return radiance + throughput * self.SKY  # depth overflow -> sky


def _whitted_scene():
    """Triangle-only mirror + glass + Lambert scene with both delta lights."""
    b = SceneBuilder()
    lam = b.add_lambert((0.7, 0.6, 0.5))
    mir = b.add_mirror((0.8, 0.8, 0.8))
    gls = b.add_glass(1.3, (0.9, 0.9, 0.9))

    def quad(p00, p10, p01):
        p00, p10, p01 = map(np.asarray, (p00, p10, p01))
        p11 = p10 + (p01 - p00)
        return np.asarray([[p00, p10, p11], [p00, p11, p01]], np.float32)

    b.add_mesh(quad((-4, 0, 2), (4, 0, 2), (-4, 0, -6)), material=lam)  # floor
    b.add_mesh(quad((-3, 0, -4), (3, 0, -4), (-3, 4, -4)), material=mir)  # back mirror
    b.add_mesh(quad((-1.2, 0.2, -1), (1.2, 0.2, -1), (-1.2, 2.6, -1)),
               material=gls)                                        # glass pane
    b.add_point_light((0.0, 3.5, 1.0), color=(1.0, 0.9, 0.8), intensity=40.0)
    b.add_distant_light((0.2, -1.0, -0.4), color=(0.9, 1.0, 1.0),
                        intensity=0.6)
    from xraytracer.math import from_rows

    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.2, 3.0, 1)
    return b.build(), dict(c2w=c2w, fov_deg=55.0)


def test_whitted_matches_oracle():
    """Whitted (mirror + glass + delta-light NEE + sky) against the
    independent scalar oracle at matched seeds — extends the oracle gate to
    the last un-oracled surface integrator (round-1 VERDICT weak item 6)."""
    from xraytracer.integrators import make_whitted_integrator

    tables, camk = _whitted_scene()
    statics = scene_statics(tables)
    cam = PinholeCamera.make(W / H, **camk)
    r = render(
        tables, cam, make_whitted_integrator(tables, statics, max_depth=3),
        W, H, SPP, seed=0,
    )
    oracle = WhittedOracle(tables, camk, W, H, seed=0)
    expect = np.zeros((H, W, 3))
    for py in range(H):
        for px in range(W):
            for s in range(SPP):
                expect[py, px] += oracle.whitted(px, py, s)
    expect /= SPP
    np.testing.assert_allclose(r.image, expect, rtol=1e-3, atol=2e-4)
    # the scene must actually exercise all three materials
    assert expect.mean() > 0.01
