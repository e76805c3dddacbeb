"""Discrete empirical 1-D distribution over RGB channels.

JAX counterpart of ``DiscreteEmpiricalDistribution1D`` (reference:
Src/sampler.h:53-97), specialized to the only use in the reference: 3-channel
spectral-MIS wavelength selection (Src/medium.h:97-115, after Wrenninge et
al., Pixar tech memo 17-07). Branch-free, batched over leading dims.
"""

import jax.numpy as jnp


def channel_pmf(values):
    """Normalized pmf over the last axis (3 channels). Guards the all-zero
    case by falling back to uniform (the C++ would produce NaNs there and get
    caught by downstream NaN checks; we choose the deliberate fix)."""
    s = jnp.sum(values, axis=-1, keepdims=True)
    uniform = jnp.full_like(values, 1.0 / values.shape[-1])
    return jnp.where(s > 0.0, values / jnp.where(s == 0.0, 1.0, s), uniform)


def sample_channel(values, u):
    """Inverse-CDF sample of a channel index given uniform ``u``.

    Matches the reference's ``lower_bound`` semantics incl. the ``x == 0``
    bump (Src/sampler.h:83-94): picks the first index whose cdf >= u.
    Returns (channel (..., int32), pmf (..., 3)).
    """
    pmf = channel_pmf(values)
    c1 = pmf[..., 0]
    c2 = pmf[..., 0] + pmf[..., 1]
    # lower_bound over cdf = [0, c1, c2, 1]: count entries strictly < u,
    # then the reference bumps x==0 to 1; channel = x - 1.
    x = (
        (0.0 < u).astype(jnp.int32)
        + (c1 < u).astype(jnp.int32)
        + (c2 < u).astype(jnp.int32)
    )
    x = jnp.maximum(x, 1)
    return x - 1, pmf


class DiscreteDistribution1D:
    """General N-bin empirical CDF container — the full
    ``DiscreteEmpiricalDistribution1D`` (reference: Src/sampler.h:53-97),
    not just the 3-channel spectral specialization above. Built once from
    concrete weights (host side, like the reference constructor); ``sample``
    is branch-free and batched, ready for many-light selection.

    CDF layout matches the reference: cdf[0] = 0, cdf[i+1] = cdf[i] + p_i
    (Src/sampler.h:60-70), sampling is ``lower_bound(cdf, u)`` with the
    x == 0 bump (Src/sampler.h:83-94), and ``pmf(i) = values[i] / sum``.
    """

    def __init__(self, values):
        import numpy as np

        v = np.asarray(values, np.float32)
        assert v.ndim == 1 and v.size >= 1
        total = float(v.sum())
        if total <= 0.0:  # deliberate fix: uniform instead of NaN
            v = np.ones_like(v)
            total = float(v.size)
        self.pmf = jnp.asarray(v / total)
        cdf = np.concatenate([[0.0], np.cumsum(v / total)])
        cdf[-1] = 1.0  # exact, like the reference's normalization
        self.cdf = jnp.asarray(cdf, jnp.float32)
        self.n = int(v.size)

    def sample(self, u):
        """Inverse-CDF sample: ``u`` (...,) uniforms -> (index (...,) int32,
        pmf_of_index (...,))."""
        # lower_bound: first cdf entry >= u == count of entries < u; the
        # reference bumps x == 0 to 1 and returns x - 1 (Src/sampler.h:88-92)
        x = jnp.sum(
            (self.cdf[None, :] < u[..., None]).astype(jnp.int32), axis=-1
        )
        idx = jnp.clip(jnp.maximum(x, 1) - 1, 0, self.n - 1)
        return idx, self.pmf[idx]
