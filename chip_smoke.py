#!/usr/bin/env python3
"""Smoke test of the path tracer on the GPU, through the entry points a user
calls, at the reference's full render sizes.

    python3 chip_smoke.py               # one card: phases 0-5
    python3 chip_smoke.py --four-cards  # four cards: the sharded paths only

Run it from the root of a checkout. It uses one process and sets no
platform: when JAX's default backend is not a GPU it exits non-zero before
doing anything else. Phases, one line each with wall time and result:

  0 device      JAX backend and devices; the card's name and power limit
  1 precision   both triangle sweeps on the 456,300 primary rays of
                cornellbox_gi against a float64 Moller-Trumbore; the
                gpu-marked tests (tests/test_gpu.py)
  2 goldens     the two CPU golden images rendered on the card
  3 cornell_gi  the CLI at 780x585, depth 3, NEE, 16 spp; 4,096 pixels
                compared with the same samples on the CPU device
  4 nee         the CLI at 780x585, depth 32, procedural cloud, 2 spp; the
                same CPU pixel check
  5 train       3 reverse-mode SGD steps on Cornell albedo and Le at
                780x585; gradient parity with the CPU device on 4,096 pixels
  four_cards    (only with --four-cards) the pixel-sharded render, the
                spp-axis psum render and the sharded train step on four
                cards against one card, and the scaling efficiency

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed. Any failure raises and exits non-zero.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")

# the reference's flagship render size (config.py cornellbox_gi / nee)
WIDTH, HEIGHT = 780, 585

# Per-pixel agreement between two renders of the same samples on two
# backends. XLA on the GPU contracts mul+add into FMA and has its own
# transcendentals, so values differ in the last bits; a pixel leaves the
# tolerance only when a discrete decision (RR, lobe pick, tracking event,
# a near-tie hit) flips on one of its samples. A flip needs the uniform to
# land within ~1e-6 relative of its threshold; the cloud golden makes ~1e3
# such decisions per pixel, so ~0.1 % of pixels, and 1 % leaves a margin of
# ten while still catching any systematic difference.
PIXEL_RTOL, PIXEL_ATOL = 1e-5, 1e-6
MAX_PIXEL_SHARE = 0.01
MAX_MEAN_REL = 0.005
# the sweep against float64 (phase 1)
SWEEP_MIN_AGREE = 0.9999
SWEEP_T_RTOL = 1e-5
# gradients: reverse-mode sums run in another order on each backend
GRAD_RTOL = 1e-3
SHARD_GRAD_RTOL = 1e-4
N_CHECK = 4096


class SmokeFailure(RuntimeError):
    """A phase's result is outside its stated bound."""


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def phases(argv):
    """Phase names selected by the command line, in run order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and what it is "
                         "compared with")
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["device", "four_cards"]
    return ["device", "precision", "goldens", "cornell_gi", "nee", "train"]


def result_line(devs):
    """The contract's last line."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    })


def report(name, t0, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] ok {time.perf_counter() - t0:.2f}s {parts}", flush=True)


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def compare_images(got, ref, label):
    """Per-pixel comparison under the stated tolerance; raises on failure.
    Returns (max_abs, share of pixels outside, relative mean difference)."""
    got = np.asarray(got, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    check(got.shape == ref.shape, f"{label}: shape {got.shape} vs {ref.shape}")
    check(np.isfinite(got).all(), f"{label}: non-finite values")
    diff = np.abs(got - ref)
    bad = np.any(diff > PIXEL_ATOL + PIXEL_RTOL * np.abs(ref), axis=-1)
    share = float(bad.mean())
    mean_rel = abs(got.mean() - ref.mean()) / max(abs(ref.mean()), 1e-30)
    check(share <= MAX_PIXEL_SHARE,
          f"{label}: {share:.4%} of pixels outside rtol={PIXEL_RTOL}, "
          f"atol={PIXEL_ATOL} (bound {MAX_PIXEL_SHARE:.0%})")
    check(mean_rel <= MAX_MEAN_REL,
          f"{label}: image means differ by {mean_rel:.3%} "
          f"(bound {MAX_MEAN_REL:.1%})")
    return float(diff.max()), share, float(mean_rel)


def mt_float64(o, d, v0, e1, e2, valid, chunk=16384):
    """Nearest-hit Moller-Trumbore in float64 numpy: the plain reference
    for the sweeps (same hit rules as geometry.intersect_triangles).
    Returns (t, idx); idx = -1 and t = inf on a miss."""
    from xraytracer.constants import K_EPS

    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    valid = np.asarray(valid, bool)
    ts, idxs = [], []
    for s in range(0, o.shape[0], chunk):
        oc, dc = o[s:s + chunk, None, :], d[s:s + chunk, None, :]
        pvec = np.cross(dc, e2[None])
        det = np.sum(e1[None] * pvec, axis=-1)
        inv = 1.0 / np.where(det == 0.0, 1.0, det)
        tvec = oc - v0[None]
        u = np.sum(tvec * pvec, axis=-1) * inv
        qvec = np.cross(tvec, e1[None])
        v = np.sum(dc * qvec, axis=-1) * inv
        t = np.sum(e2[None] * qvec, axis=-1) * inv
        ok = ((np.abs(det) >= K_EPS) & (u >= 0) & (u <= 1) & (v >= 0)
              & (u + v <= 1) & (t > K_EPS) & valid[None])
        t = np.where(ok, t, np.inf)
        i = np.argmin(t, axis=1)
        tmin = t[np.arange(t.shape[0]), i]
        ts.append(tmin)
        idxs.append(np.where(np.isfinite(tmin), i, -1))
    return np.concatenate(ts), np.concatenate(idxs)


def cornell_primary_rays(width, height):
    """(tables, rays) for sample 0 of every pixel of the cornellbox_gi
    camera, made the renderer's way."""
    import jax
    import jax.numpy as jnp

    from xraytracer.camera import PinholeCamera
    from xraytracer.renderer import CAMERA_SITE, pixel_grid
    from xraytracer.sampling import path_keys, uniform2
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    tables = build_cornell_box().build()
    camera = PinholeCamera.make(width / height, **cornell_camera())
    ids, xy = pixel_grid(width, height)
    wh = jnp.asarray([float(width), float(height)])

    @jax.jit
    def rays_of(ids, xy):
        u = uniform2(path_keys(0, ids, 0), CAMERA_SITE)
        return camera.sample_rays((xy + u) / wh)

    return tables, rays_of(ids, xy)


def timed(fn, *args, reps=5):
    """(result, compile+first-call seconds, median steady ms)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, 1e3 * float(np.median(times))


def sweep_phase(width=WIDTH, height=HEIGHT):
    """Both triangle sweeps against float64; prints each one's time."""
    import jax

    from xraytracer.geometry.intersect import (
        intersect_triangles,
        intersect_triangles_mm,
    )

    tables, rays = cornell_primary_rays(width, height)
    args = (rays, tables.tri_v0, tables.tri_e1, tables.tri_e2,
            tables.tri_obj >= 0)
    t64, i64 = mt_float64(np.asarray(rays.o), np.asarray(rays.d),
                          *(np.asarray(a) for a in args[1:]))
    out = {}
    for name, fn in (("mm", intersect_triangles_mm),
                     ("classic", intersect_triangles)):
        f = jax.jit(fn)
        (t, i, _, _), first, ms = timed(f, *args)
        temp = f.lower(*args).compile().memory_analysis().temp_size_in_bytes
        t, i = np.asarray(t, np.float64), np.asarray(i)
        agree = float((i == i64).mean())
        both = (i == i64) & (i64 >= 0)
        rel = np.abs(t[both] - t64[both]) / t64[both]
        max_rel = float(rel.max()) if rel.size else 0.0
        check(agree >= SWEEP_MIN_AGREE,
              f"sweep {name}: winner agrees on {agree:.5%} of rays "
              f"(bound {SWEEP_MIN_AGREE:.2%})")
        check(max_rel <= SWEEP_T_RTOL,
              f"sweep {name}: max |t - t64|/t64 = {max_rel:.3g} "
              f"(bound {SWEEP_T_RTOL})")
        out[name] = dict(ms=round(ms, 3), first_s=round(first, 2),
                         agree=agree, max_t_rel=max_rel, temp_bytes=temp)
    out["rays"] = int(t64.shape[0])
    out["hit_share"] = float((i64 >= 0).mean())
    return out


def gpu_tests_phase():
    """The gpu-marked tests, in this process, on the card."""
    import pytest

    os.environ["XRT_TESTS_ON_GPU"] = "1"
    rc = pytest.main([
        "-q", "-p", "no:cacheprovider", "-p", "no:xdist", "-o", "addopts=",
        "-m", "gpu", os.path.join(REPO, "tests", "test_gpu.py"),
    ])
    check(rc == 0, f"gpu-marked tests failed (pytest exit code {int(rc)})")


def _load_golden_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_renders", os.path.join(REPO, "tests", "test_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def goldens_phase():
    g = _load_golden_module()
    out = {}
    for name, render_fn, path in (
        ("cornell", g.cornell_gi_render, g.GOLDEN),
        ("cloud", g.cloud_nee_render, g.VOLUME_GOLDEN),
    ):
        r = render_fn()
        check(r.n_rejected == 0, f"golden {name}: {r.n_rejected} rejected")
        max_abs, share, mean_rel = compare_images(
            r.image, np.load(path), f"golden {name}")
        out[name] = dict(max_abs=max_abs, share_out=share, mean_rel=mean_rel)
    return out


def cpu_reference(cfg, pixel_ids, spp):
    """Mean radiance of samples 0..spp-1 of ``pixel_ids`` under ``cfg``,
    computed on the CPU device through the CLI's own scene and integrator
    factories (the RNG key is a pure function of seed, pixel and sample)."""
    import jax
    import jax.numpy as jnp

    from xraytracer import cli
    from xraytracer.camera import PinholeCamera
    from xraytracer.renderer import make_sample_fn
    from xraytracer.scene.builder import scene_statics

    with jax.default_device(jax.devices("cpu")[0]):
        tables, cam_kwargs = cli.build_scene(cfg)
        statics = scene_statics(tables)
        camera = PinholeCamera.make(cfg.width / cfg.height, **cam_kwargs)
        integrate = cli.make_integrator(cfg, tables, statics)
        sample = jax.jit(make_sample_fn(
            tables, camera, integrate, cfg.width, cfg.height, cfg.seed))
        ids = np.asarray(pixel_ids, np.int32)
        xy = np.stack([ids % cfg.width, ids // cfg.width], -1)
        ids, xy = jnp.asarray(ids), jnp.asarray(xy.astype(np.float32))
        acc = np.zeros((ids.shape[0], 3), np.float64)
        for s in range(spp):
            rad, _, _ = sample(ids, xy, s)
            acc += np.asarray(rad)
    return acc / spp


def cli_phase(preset, spp, out_dir=OUT_DIR, width=None, height=None,
              n_check=N_CHECK):
    """One CLI render, its output checks, a steady-state timing with a held
    renderer of the same configuration, and the CPU pixel-subset check."""
    import jax

    from xraytracer import cli
    from xraytracer.camera import PinholeCamera
    from xraytracer.config import get_preset
    from xraytracer.renderer import WavefrontRenderer
    from xraytracer.scene.builder import scene_statics

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, f"{preset}.png")
    if os.path.exists(png):
        os.remove(png)
    argv = ["--preset", preset, "--spp", str(spp), "-o", png]
    if width:
        argv += ["--width", str(width), "--height", str(height)]
    result = cli.run(argv)
    check(result.n_rejected == 0, f"{preset}: {result.n_rejected} rejected")
    check(np.isfinite(result.image).all(), f"{preset}: non-finite image")
    with open(png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"{preset}: no PNG written")

    cfg = get_preset(preset, spp=spp, width=width, height=height)
    tables, cam_kwargs = cli.build_scene(cfg)
    camera = PinholeCamera.make(cfg.width / cfg.height, **cam_kwargs)
    r = WavefrontRenderer(
        tables, camera, cli.make_integrator(cfg, tables, scene_statics(tables)),
        cfg.width, cfg.height, seed=cfg.seed)
    first = r.render(1).seconds
    steady = r.render(spp)
    per_spp = steady.seconds / spp

    rng = np.random.default_rng(0)
    n_pix = cfg.width * cfg.height
    ids = rng.choice(n_pix, size=min(n_check, n_pix), replace=False)
    ref = cpu_reference(cfg, ids, spp)
    got = result.image.reshape(-1, 3)[ids]
    max_abs, share, mean_rel = compare_images(got, ref, f"{preset} vs cpu")
    return dict(
        size=f"{cfg.width}x{cfg.height}", spp=spp, depth=cfg.max_depth,
        rays_per_s=round(steady.samples_per_sec),
        ms_per_spp=round(1e3 * per_spp, 3),
        # the CLI render compiled from scratch; the held renderer's first
        # call found the compile cache the CLI filled
        compile_cold_s=round(result.seconds - steady.seconds, 2),
        compile_warm_s=round(first - per_spp, 2),
        cpu_max_abs=max_abs, cpu_share_out=share, cpu_mean_rel=mean_rel,
        peak_bytes=peak_bytes(jax.devices()[0]),
    )


def train_phase(width=WIDTH, height=HEIGHT, steps=3, lr=4.0,
                n_check=N_CHECK):
    """Reverse-mode SGD on Cornell albedo and Le: the loss falls over
    ``steps`` steps against the true scene's render of the same stream, and
    the gradient on a pixel subset matches the CPU device's."""
    import jax
    import jax.numpy as jnp

    from xraytracer.camera import PinholeCamera
    from xraytracer.diff import make_loss_fn, make_radiance_fn, make_train_step
    from xraytracer.renderer import pixel_grid
    from xraytracer.scene.builder import scene_statics
    from xraytracer.scene.presets import build_cornell_box, cornell_camera

    def problem():
        tables = build_cornell_box().build()
        camera = PinholeCamera.make(width / height, **cornell_camera())
        radiance = make_radiance_fn(
            tables, scene_statics(tables), camera, width, height, max_depth=3)
        start = {
            "mat_albedo": np.asarray(tables.mat_albedo) * 0.6 + 0.2,
            "al_le": np.asarray(tables.al_le) * 0.8,
        }
        true = {"mat_albedo": tables.mat_albedo, "al_le": tables.al_le}
        return radiance, start, true

    radiance, start, true = problem()
    ids, xy = pixel_grid(width, height)
    target = jax.jit(radiance)(true, ids, xy, 0)
    step = jax.jit(make_train_step(radiance, lr=lr))
    params = {k: jnp.asarray(v) for k, v in start.items()}
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, _ = step(params, ids, xy, target, 0)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    check(np.isfinite(losses).all(), f"train: non-finite loss {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"train: loss does not fall across steps: {losses}")

    rng = np.random.default_rng(1)
    sub = np.sort(rng.choice(width * height, size=min(n_check, width * height),
                             replace=False)).astype(np.int32)
    sub_xy = np.stack([sub % width, sub // width], -1).astype(np.float32)
    tgt_sub = np.asarray(target)[sub]
    grad_fn = jax.jit(jax.grad(make_loss_fn(radiance)))
    g_dev = grad_fn(start, sub, sub_xy, tgt_sub, 0)
    with jax.default_device(jax.devices("cpu")[0]):
        radiance_cpu, _, _ = problem()
        g_cpu = jax.jit(jax.grad(make_loss_fn(radiance_cpu)))(
            start, sub, sub_xy, tgt_sub, 0)
    for k in start:
        a, b = np.asarray(g_dev[k]), np.asarray(g_cpu[k])
        check(np.abs(b).max() > 0.0, f"train: zero CPU gradient for {k}")
        np.testing.assert_allclose(
            a, b, rtol=GRAD_RTOL, atol=1e-6 * np.abs(b).max(),
            err_msg=f"train: {k} gradient, card vs CPU")
    return dict(
        size=f"{width}x{height}", losses=[round(x, 8) for x in losses],
        first_step_s=round(times[0], 2),
        step_ms=round(1e3 * float(np.mean(times[1:])), 3),
        peak_bytes=peak_bytes(jax.devices()[0]),
    )


def four_card_phase(devs, width=WIDTH, height=HEIGHT, spp=16):
    """Sharded render, psum render and sharded train step on four devices,
    each against the same work on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xraytracer import cli
    from xraytracer.camera import PinholeCamera
    from xraytracer.config import get_preset
    from xraytracer.diff import make_radiance_fn, make_train_step
    from xraytracer.parallel import make_mesh, spp_parallel_render
    from xraytracer.renderer import (
        WavefrontRenderer,
        make_sample_fn,
        pixel_grid,
        pixel_sharding,
    )
    from xraytracer.scene.builder import scene_statics

    check(len(devs) >= 4, f"four_cards: {len(devs)} devices")
    mesh = make_mesh(4)
    cfg = get_preset("cornellbox_gi", spp=spp, width=width, height=height)
    tables, cam_kwargs = cli.build_scene(cfg)
    statics = scene_statics(tables)
    camera = PinholeCamera.make(width / height, **cam_kwargs)
    integrate = cli.make_integrator(cfg, tables, statics)

    one = WavefrontRenderer(tables, camera, integrate, width, height,
                            seed=cfg.seed)
    four = WavefrontRenderer(tables, camera, integrate, width, height,
                             seed=cfg.seed, sharding=pixel_sharding(mesh))
    one.render(1)
    four.render(1)
    r1, r4 = one.render(spp), four.render(spp)
    check(r4.n_rejected == 0, f"four_cards: {r4.n_rejected} rejected")
    shard_cmp = compare_images(r4.image, r1.image, "pixel-sharded vs 1 card")

    ids, xy = pixel_grid(width, height)
    sample_once = make_sample_fn(tables, camera, integrate, width, height,
                                 cfg.seed)
    acc, rej = spp_parallel_render(tables, sample_once, ids, xy, spp, mesh)
    check(int(rej) == 0, f"four_cards: psum render rejected {int(rej)}")
    psum_cmp = compare_images(
        np.asarray(acc).reshape(height, width, 3) / spp, r1.image,
        "spp psum vs 1 card")

    radiance = make_radiance_fn(tables, statics, camera, width, height,
                                max_depth=3)
    target = jax.jit(radiance)(
        {"mat_albedo": tables.mat_albedo, "al_le": tables.al_le}, ids, xy, 1)
    params = {"mat_albedo": tables.mat_albedo * 0.6 + 0.2,
              "al_le": tables.al_le * 0.8}
    step = make_train_step(radiance)
    _, _, g1 = jax.jit(step)(params, ids, xy, target, 0)
    shard, repl = NamedSharding(mesh, P("d")), NamedSharding(mesh, P())
    _, _, g4 = jax.jit(step)(
        jax.device_put(params, repl), jax.device_put(ids, shard),
        jax.device_put(xy, shard), jax.device_put(target, shard), 0)
    for k in params:
        a, b = np.asarray(g4[k]), np.asarray(g1[k])
        np.testing.assert_allclose(
            a, b, rtol=SHARD_GRAD_RTOL, atol=1e-6 * np.abs(b).max(),
            err_msg=f"four_cards: sharded {k} gradient vs 1 card")
    # scaling: best of 3 longer renders on each, both warm
    t_spp = 4 * spp
    s1 = min(one.render(t_spp).seconds for _ in range(3)) / t_spp
    s4 = min(four.render(t_spp).seconds for _ in range(3)) / t_spp
    return dict(
        size=f"{width}x{height}", spp=spp,
        one_card_ms_per_spp=round(1e3 * s1, 4),
        four_card_ms_per_spp=round(1e3 * s4, 4),
        scaling_efficiency=round(s1 / s4 / 4, 4),
        shard_share_out=shard_cmp[1], psum_share_out=psum_cmp[1],
        psum_max_abs=psum_cmp[0],
    )


def main(argv=None):
    selected = phases(argv)
    from xraytracer.compile_cache import enable_compile_cache
    from xraytracer.device import nvidia_smi_name_power, require_gpu

    t0 = time.perf_counter()
    devs = require_gpu()
    cache = enable_compile_cache()
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)} compile_cache={cache}", flush=True)
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)
    report("0 device", t0)

    for name in selected[1:]:
        t0 = time.perf_counter()
        if name == "precision":
            res = sweep_phase()
            gpu_tests_phase()
            report("1 precision", t0, **res)
        elif name == "goldens":
            report("2 goldens", t0, **goldens_phase())
        elif name == "cornell_gi":
            report("3 cornell_gi", t0, **cli_phase("cornellbox_gi", 16))
        elif name == "nee":
            report("4 nee", t0, **cli_phase("nee", 2))
        elif name == "train":
            report("5 train", t0, **train_phase())
        elif name == "four_cards":
            report("four_cards", t0, **four_card_phase(devs))
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
