"""Counter-based, per-path RNG.

The reference uses one stateful ``std::mt19937`` per pixel, seeded with the
pixel index (reference: Src/sampler.h:37-50, Src/renderer.cpp:35-36), which
gives per-pixel deterministic renders. On an accelerator that becomes a *counter-based*
scheme: each random draw is a pure function of

    (seed, global pixel id, sample index, site counter)

so renders are bitwise deterministic regardless of chunking, device count, or
host count (SURVEY §7 "multi-host determinism"). ``site`` counters enumerate
every consumption point inside an integrator; each wavefront bounce offsets
them by ``SITES_PER_BOUNCE``.

Implementation: the PCG output-permutation hash (O'Neill's PCG-XSH-RR family
as popularized for GPU rendering by Jarzynski & Olano, "Hash Functions for
GPU Rendering", JCGT 2020) — ~8 integer ops per draw. The first build
used ``jax.random`` threefry (16+ rounds per draw); with ~30 draws per
primary ray the RNG dominated the GI profile, so the hash is the hot-path
choice. Statistical quality is validated by the chi-square/moment tests in
tests/test_sampling.py.
"""

import jax.numpy as jnp
import numpy as np

# Generous per-bounce site budget: every integrator must consume fewer than
# this many distinct random sites per bounce (incl. tracking loop sites).
SITES_PER_BOUNCE = 1 << 16

_GOLDEN = np.uint32(0x9E3779B9)  # Weyl increment for site separation
_M1 = np.uint32(747796405)
_A1 = np.uint32(2891336453)
_M2 = np.uint32(277803737)
_INV24 = np.float32(1.0 / (1 << 24))


def _pcg(x):
    """One PCG hash round on uint32 lanes (pcg-xsh-rr output permutation)."""
    x = x * _M1 + _A1
    word = ((x >> ((x >> np.uint32(28)) + np.uint32(4))) ^ x) * _M2
    return (word >> np.uint32(22)) ^ word


def _to_unit_float(x):
    """uint32 -> float32 in [0, 1): top 24 bits scaled by 2^-24."""
    return (x >> np.uint32(8)).astype(jnp.float32) * _INV24


def base_key(seed):
    """Root state for a render (uint32 scalar)."""
    return _pcg(jnp.uint32(np.uint32(seed)))


def path_keys(seed, pixel_ids, sample_idx):
    """Per-path uint32 states: fold the global pixel id and the sample index
    into the root. ``pixel_ids`` is (N,) int; ``sample_idx`` scalar int
    (static or traced).

    Counterpart of ``sampler->setSeed(j + width * i)`` + the spp loop
    (reference: Src/renderer.cpp:36,42).
    """
    s = _pcg(base_key(seed) + pixel_ids.astype(jnp.uint32))
    return _pcg(s + jnp.asarray(sample_idx).astype(jnp.uint32))


def _site_state(keys, site):
    return keys + jnp.asarray(site).astype(jnp.uint32) * _GOLDEN


def uniform1(keys, site):
    """One uniform float in [0,1) per path. keys: (N,) uint32 -> (N,)."""
    return _to_unit_float(_pcg(_site_state(keys, site)))


def uniform2(keys, site):
    """Two uniforms per path -> (N, 2). Consumes a single site."""
    x1 = _pcg(_site_state(keys, site))
    x2 = _pcg(x1)
    return jnp.stack([_to_unit_float(x1), _to_unit_float(x2)], axis=-1)


def uniform3(keys, site):
    """Three uniforms per path -> (N, 3). Consumes a single site."""
    x1 = _pcg(_site_state(keys, site))
    x2 = _pcg(x1)
    x3 = _pcg(x2)
    return jnp.stack(
        [_to_unit_float(x1), _to_unit_float(x2), _to_unit_float(x3)], axis=-1
    )


def scalar_uniform(key, site, shape=()):
    """Uniforms from a single (non-batched) state, used by scalar oracles."""
    base = _site_state(jnp.asarray(key, jnp.uint32), site)
    n = int(np.prod(shape)) if shape else 1
    idx = jnp.arange(n, dtype=jnp.uint32)
    out = _to_unit_float(_pcg(base + idx * np.uint32(0x85EBCA6B)))
    return out.reshape(shape) if shape else out[0]
