"""Execution layer: wavefront renderer, accumulation, sharding, checkpoints.

Accelerator counterpart of the reference's ``NormalRenderer`` /
``ParallelRenderer`` (reference: Src/renderer.cpp:8-99). The per-pixel
double loop + spp loop becomes: one wavefront of all pixels, one jitted
single-spp step (compiled once) dispatched per sample, and —
the ``ParallelRenderer`` analogue — the pixel axis sharded over a device
mesh with ``NamedSharding``; no collectives are needed because every lane
owns its pixel (the same disjointness argument as the reference's
``std::for_each(par_unseq)``, Src/renderer.cpp:90-93).

Reference semantics preserved:
  * jittered sub-pixel SSAA: uv = ((x + u), (y + v)) / (W, H)
    (Src/renderer.cpp:42-47);
  * per-sample NaN/Inf/negative radiance REJECTION with a running count
    (Src/renderer.cpp:56-73) — rejected samples contribute 0 but still
    divide by the full spp;
  * per-pixel determinism: the RNG key is a pure function of
    (seed, global pixel id, sample index), so renders are bitwise identical
    across chunkings, device counts, and hosts (SURVEY.md §7).

Checkpoint/resume (absent in the reference, SURVEY.md §5): spp is
accumulated in chunks; the accumulator (sum buffer + rejected count +
samples done) round-trips through an .npz file between chunks.
"""

import time
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Rays
from .parallel.mesh import replicated
from .sampling import path_keys, uniform2

# Dedicated RNG site for camera jitter, far above any per-bounce block
# (bounce i uses sites [i * SITES_PER_BOUNCE, (i+1) * SITES_PER_BOUNCE)).
CAMERA_SITE = 0x7FFF0000


def _morton_argsort(width, height):
    """Lane order that visits pixels along a Z-order curve: consecutive
    lanes then cover compact 2-D pixel BLOCKS instead of full scanlines,
    so neighbouring lanes trace spatially coherent rays."""
    ids = np.arange(width * height, dtype=np.int64)
    x = (ids % width).astype(np.uint32)
    y = (ids // width).astype(np.uint32)

    def spread(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    code = (spread(x) << np.uint32(1)) | spread(y)
    return np.argsort(code, kind="stable").astype(np.int32)


def pixel_grid(width, height, order="raster"):
    """Global pixel ids and pixel (x, y), in lane-traversal order.

    Pixel IDs stay row-major (matching the reference's ``j + width * i``
    seeding, Src/renderer.cpp:36) — per-pixel RNG streams and therefore
    the IMAGE are identical for every ``order``; only the lane TRAVERSAL
    changes ("morton" visits pixels Z-order, and image assembly
    un-permutes)."""
    ids = np.arange(width * height, dtype=np.int32)
    if order == "morton":
        ids = ids[_morton_argsort(width, height)]
    x = (ids % width).astype(np.float32)
    y = (ids // width).astype(np.float32)
    return jnp.asarray(ids), jnp.asarray(np.stack([x, y], axis=-1))


def make_sample_fn(scene, camera, integrate, width, height, seed):
    """One-spp wavefront kernel: (pixel_ids, pixel_xy, sample_idx) ->
    (radiance (N,3), n_rejected). Jit-compiled once, reused for every spp."""
    wh = jnp.asarray([float(width), float(height)])

    def sample_once(pixel_ids, pixel_xy, s):
        keys = path_keys(seed, pixel_ids, s)
        u = uniform2(keys, CAMERA_SITE)
        uv = (pixel_xy + u) / wh
        rays = camera.sample_rays(uv)
        out = integrate(rays, keys)
        # with_stats integrators return (radiance, per-bounce counter dict)
        rad, stats = out if isinstance(out, tuple) else (out, None)
        # rejection (Src/renderer.cpp:56-73): any nan/inf/negative channel
        # voids the whole sample
        bad = jnp.any(~jnp.isfinite(rad) | (rad < 0.0), axis=-1)
        rad = jnp.where(bad[:, None], 0.0, rad)
        return rad, jnp.sum(bad.astype(jnp.int32)), stats

    return sample_once


def make_chunk_fn(sample_once, donate=True):
    """spp-chunk accumulator: one jitted single-spp accumulate step,
    dispatched from a host loop with a donated accumulator.

    Host dispatch is asynchronous, so each step's enqueue overlaps the
    previous step's device work; the compiled program is one sample deep,
    which keeps compile time independent of spp.
    """

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(acc, nrej, pixel_ids, pixel_xy, s):
        rad, bad, stats = sample_once(pixel_ids, pixel_xy, s)
        return acc + rad, nrej + bad, stats

    def run_chunk(acc, nrej, pixel_ids, pixel_xy, s0, n, stats_acc=None):
        for i in range(n):
            acc, nrej, stats = step(acc, nrej, pixel_ids, pixel_xy, s0 + i)
            if stats is not None:
                stats_acc = (
                    stats if stats_acc is None
                    else jax.tree.map(lambda a, b: a + b, stats_acc, stats)
                )
        return acc, nrej, stats_acc

    return run_chunk


@dataclass
class RenderResult:
    image: np.ndarray      # (H, W, 3) float32, averaged radiance
    spp: int
    n_rejected: int
    seconds: float
    samples_per_sec: float  # primary camera samples (pixels*spp) per second
    # per-bounce counters summed over the whole render (SURVEY.md §5),
    # present when the integrator was built with ``with_stats=True``:
    # e.g. {"rays": (D,), "shadow_rays": (D,), "rr_killed": (D,), ...}
    stats: dict | None = None

    @property
    def total_rays(self):
        """All rays traced (primary + bounce + shadow); falls back to
        primary samples when stats were not collected."""
        if self.stats is None:
            return None
        t = int(np.asarray(self.stats["rays"]).sum())
        if "shadow_rays" in self.stats:
            t += int(np.asarray(self.stats["shadow_rays"]).sum())
        return t


class Accumulator:
    """Checkpointable spp accumulation state."""

    def __init__(self, width, height, acc=None, n_rejected=0, spp_done=0,
                 pixel_perm=None):
        self.width = width
        self.height = height
        self.acc = (
            acc if acc is not None else jnp.zeros((width * height, 3), jnp.float32)
        )
        self.n_rejected = n_rejected
        self.spp_done = spp_done
        # lane -> pixel-id map when the renderer traverses pixels out of
        # raster order (pixel_grid(order="morton")); None = raster
        self.pixel_perm = pixel_perm

    def save(self, path):
        extra = {}
        if self.pixel_perm is not None:
            extra["pixel_perm"] = np.asarray(self.pixel_perm)
        np.savez(
            path,
            acc=np.asarray(self.acc),
            n_rejected=np.asarray(self.n_rejected),
            spp_done=self.spp_done,
            width=self.width,
            height=self.height,
            **extra,
        )

    @staticmethod
    def load(path):
        z = np.load(path)
        return Accumulator(
            int(z["width"]), int(z["height"]),
            acc=jnp.asarray(z["acc"]),
            n_rejected=jnp.asarray(z["n_rejected"]),
            spp_done=int(z["spp_done"]),
            pixel_perm=z["pixel_perm"] if "pixel_perm" in z else None,
        )

    def image(self):
        spp = max(self.spp_done, 1)
        a = np.asarray(self.acc)
        if self.pixel_perm is not None:
            out = np.empty_like(a)
            out[self.pixel_perm] = a
            a = out
        return a.reshape(self.height, self.width, 3) / spp


class WavefrontRenderer:
    """Reusable compiled pipeline for one (scene, camera, integrator,
    resolution, seed) configuration. Construct ONCE, call ``render`` many
    times — each ``render()`` reuses the same jitted step, so only the
    first call pays compilation (a fresh ``render(...)`` helper call
    rebuilds closures and recompiles every time)."""

    def __init__(
        self, scene, camera, integrate, width, height, seed=0, sharding=None,
        pixel_order="auto",
    ):
        self.width = width
        self.height = height
        self.sharding = sharding
        self.n_pix = width * height
        if pixel_order == "auto":
            # Z-order traversal for multi-chunk triangle tables
            # (> 128 rows), where ray coherence across lanes matters
            try:
                big = int(np.sum(np.asarray(scene.tri_obj) >= 0)) > 128
            except Exception:
                big = False
            pixel_order = "morton" if big else "raster"
        self.pixel_order = pixel_order
        pixel_ids, pixel_xy = pixel_grid(width, height, order=pixel_order)
        self._ids_np = np.asarray(pixel_ids)
        self._pad = 0
        if sharding is not None:
            # pad the pixel axis to a multiple of the device count; padding
            # lanes render pixel 0 and are sliced off before averaging
            n_dev = sharding.mesh.size
            self._pad = (-self.n_pix) % n_dev
            if self._pad:
                pixel_ids = jnp.pad(pixel_ids, (0, self._pad))
                pixel_xy = jnp.pad(pixel_xy, ((0, self._pad), (0, 0)))
            pixel_ids = jax.device_put(pixel_ids, sharding)
            pixel_xy = jax.device_put(pixel_xy, sharding)
        self.pixel_ids = pixel_ids
        self.pixel_xy = pixel_xy
        self.sample_once = make_sample_fn(
            scene, camera, integrate, width, height, seed
        )
        self.run_chunk = make_chunk_fn(self.sample_once)

    def render(
        self, spp, spp_chunk=None, accumulator=None, checkpoint_path=None
    ):
        spp_chunk = spp_chunk or spp
        acc_state = accumulator or Accumulator(self.width, self.height)
        new_perm = self._ids_np if self.pixel_order == "morton" else None
        old_perm = acc_state.pixel_perm

        def _same(a, b):
            if (a is None) != (b is None):
                return False
            return a is None or np.array_equal(np.asarray(a), np.asarray(b))

        if acc_state.spp_done and not _same(old_perm, new_perm):
            # resumed checkpoint written under a DIFFERENT lane traversal
            # (e.g. raster-era checkpoint resumed by an auto-morton
            # renderer): remap the stored sums into this renderer's lane
            # order so accumulation stays per-pixel consistent
            a = np.asarray(acc_state.acc)
            by_pixel = np.empty_like(a)
            if old_perm is not None:
                by_pixel[np.asarray(old_perm)] = a
            else:
                by_pixel = a
            acc_state.acc = jnp.asarray(
                by_pixel[new_perm] if new_perm is not None else by_pixel
            )
        acc_state.pixel_perm = new_perm
        acc = acc_state.acc
        if self._pad:
            acc = jnp.pad(acc, ((0, self._pad), (0, 0)))
        nrej = jnp.asarray(acc_state.n_rejected, jnp.int32)
        if self.sharding is not None:
            # the step returns the rejected count replicated; pass it in
            # that way from the start, or the second step recompiles
            acc = jax.device_put(acc, self.sharding)
            nrej = jax.device_put(nrej, replicated(self.sharding.mesh))
        spp_resumed = acc_state.spp_done
        stats_acc = None
        t0 = time.perf_counter()
        s = acc_state.spp_done
        while s < spp:
            n = min(spp_chunk, spp - s)
            acc, nrej, stats_acc = self.run_chunk(
                acc, nrej, self.pixel_ids, self.pixel_xy, s, n,
                stats_acc=stats_acc,
            )
            s += n
            acc_state.acc = acc[:self.n_pix]
            acc_state.n_rejected = nrej
            acc_state.spp_done = s
            if checkpoint_path is not None:
                jax.block_until_ready(acc)
                acc_state.save(checkpoint_path)
        jax.block_until_ready(acc)
        dt = time.perf_counter() - t0

        img_flat = np.empty((self.n_pix, 3), np.float32)
        img_flat[self._ids_np] = np.asarray(acc[:self.n_pix])
        img = img_flat.reshape(self.height, self.width, 3) / spp
        n_samples = self.n_pix * max(spp - spp_resumed, 0)
        return RenderResult(
            image=img,
            spp=spp,
            n_rejected=int(nrej),
            seconds=dt,
            samples_per_sec=n_samples / max(dt, 1e-9),
            stats=(
                None if stats_acc is None
                else {k: np.asarray(v) for k, v in stats_acc.items()}
            ),
        )


def render(
    scene, camera, integrate, width, height, spp,
    seed=0, spp_chunk=None, accumulator=None, checkpoint_path=None,
    sharding=None,
):
    """One-shot convenience wrapper around ``WavefrontRenderer`` (compiles
    per call — hold a ``WavefrontRenderer`` to amortize compilation).

    ``sharding``: optional ``jax.sharding.NamedSharding`` over the pixel
    axis — the multi-chip ``ParallelRenderer``. All inputs along the pixel
    axis are placed with it; the scene pytree is replicated by jit.
    """
    r = WavefrontRenderer(
        scene, camera, integrate, width, height, seed=seed, sharding=sharding
    )
    return r.render(
        spp, spp_chunk=spp_chunk, accumulator=accumulator,
        checkpoint_path=checkpoint_path,
    )


def pixel_sharding(mesh, axis="d"):
    """NamedSharding that splits the pixel axis across ``mesh``'s ``axis``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(axis))


def default_mesh(axis="d"):
    """1-D mesh over all local devices."""
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    return Mesh(devs, (axis,))
