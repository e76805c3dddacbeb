import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xraytracer import sampling as xs
from xraytracer.constants import PI


def test_path_keys_deterministic_and_distinct():
    pix = jnp.arange(16, dtype=jnp.int32)
    k1 = xs.path_keys(0, pix, 3)
    k2 = xs.path_keys(0, pix, 3)
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    u = np.asarray(xs.uniform1(k1, 0))
    assert len(np.unique(u)) == 16  # distinct streams per pixel


def test_uniform_independent_of_batching():
    """The same (pixel, sample, site) triple must give the same value no
    matter how pixels are grouped into wavefront chunks."""
    all_pix = jnp.arange(64, dtype=jnp.int32)
    full = np.asarray(xs.uniform1(xs.path_keys(7, all_pix, 1), 5))
    lo = np.asarray(xs.uniform1(xs.path_keys(7, all_pix[:32], 1), 5))
    hi = np.asarray(xs.uniform1(xs.path_keys(7, all_pix[32:], 1), 5))
    np.testing.assert_array_equal(full, np.concatenate([lo, hi]))


def test_uniform_hemisphere_distribution():
    keys = xs.path_keys(0, jnp.arange(20000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    d = np.asarray(xs.uniform_hemisphere(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert (d[:, 1] >= 0).all()
    # uniform on hemisphere: E[cos theta] = 1/2
    np.testing.assert_allclose(d[:, 1].mean(), 0.5, atol=0.01)


def test_cosine_hemisphere_distribution():
    keys = xs.path_keys(1, jnp.arange(20000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    d = np.asarray(xs.cosine_hemisphere(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # cosine-weighted: E[cos theta] = 2/3
    np.testing.assert_allclose(d[:, 1].mean(), 2.0 / 3.0, atol=0.01)


def test_uniform_triangle_inside():
    a = np.array([0.0, 0, 0], np.float32)
    b = np.array([1.0, 0, 0], np.float32)
    c = np.array([0.0, 1, 0], np.float32)
    keys = xs.path_keys(2, jnp.arange(5000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    p = np.asarray(xs.uniform_triangle(u[:, 0], u[:, 1], a, b, c))
    assert (p[:, 0] >= -1e-6).all() and (p[:, 1] >= -1e-6).all()
    assert (p[:, 0] + p[:, 1] <= 1 + 1e-5).all()
    # centroid of uniform samples ~ (1/3, 1/3)
    np.testing.assert_allclose(p.mean(0)[:2], [1 / 3, 1 / 3], atol=0.01)


def test_uniform_sphere_mean_zero():
    keys = xs.path_keys(3, jnp.arange(20000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    d = np.asarray(xs.uniform_sphere(u[:, 0], u[:, 1]))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d.mean(0), 0.0, atol=0.02)


def test_uniform_cone_within():
    keys = xs.path_keys(4, jnp.arange(5000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    x = np.array([1.0, 0, 0], np.float32)
    y = np.array([0.0, 1, 0], np.float32)
    z = np.array([0.0, 0, 1], np.float32)
    cos_max = 0.8
    d = np.asarray(xs.uniform_cone(u[:, 0], u[:, 1], cos_max, x, y, z))
    assert (d[:, 2] >= cos_max - 1e-5).all()
    # uniform in cos: mean cos = (1+cos_max)/2
    np.testing.assert_allclose(d[:, 2].mean(), (1 + cos_max) / 2, atol=0.005)


def test_hg_phase_normalization():
    # integral of phase over sphere == 1 (quadrature over cos theta)
    for g in [0.0, 0.5, -0.3, 0.9]:
        ct = np.linspace(-1, 1, 20001)
        ph = np.asarray(xs.hg_phase(jnp.asarray(ct), g))
        integral = 2 * PI * np.trapezoid(ph, ct)
        np.testing.assert_allclose(integral, 1.0, rtol=1e-3)


def test_hg_sample_matches_phase():
    # sampled cos theta distribution has E[cos] = g (HG property)
    keys = xs.path_keys(5, jnp.arange(40000, dtype=jnp.int32), 0)
    u = np.asarray(xs.uniform2(keys, 0))
    for g in [0.0, 0.6, -0.4]:
        ct = np.asarray(xs.hg_sample_cos_theta(jnp.asarray(u[:, 0]), g))
        np.testing.assert_allclose(ct.mean(), g, atol=0.01)


def test_hg_sample_direction_unit_and_value():
    wo = jnp.asarray(np.tile([[0.0, 0.0, 1.0]], (1000, 1)).astype(np.float32))
    keys = xs.path_keys(6, jnp.arange(1000, dtype=jnp.int32), 0)
    u = xs.uniform2(keys, 0)
    wi, ph = xs.hg_sample_direction(wo, u[:, 0], u[:, 1], 0.7)
    wi, ph = np.asarray(wi), np.asarray(ph)
    np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-5)
    cos = np.sum(wi * np.asarray(wo), -1)
    np.testing.assert_allclose(
        ph, np.asarray(xs.hg_phase(jnp.asarray(cos), 0.7)), rtol=2e-4, atol=1e-6
    )


def test_channel_pmf_and_sample():
    vals = jnp.array([[1.0, 2.0, 1.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    ch, pmf = xs.sample_channel(vals, jnp.array([0.1, 0.5, 0.999]))
    pmf = np.asarray(pmf)
    np.testing.assert_allclose(pmf[0], [0.25, 0.5, 0.25])
    np.testing.assert_allclose(pmf[1], [1 / 3, 1 / 3, 1 / 3])
    ch = np.asarray(ch)
    assert ch[0] == 0  # u=0.1 < 0.25
    assert ch[1] == 1  # uniform fallback, u=0.5 in (1/3, 2/3]
    assert ch[2] == 0  # all mass on channel 0


def test_sample_channel_statistics():
    vals = jnp.tile(jnp.array([[1.0, 3.0, 6.0]]), (30000, 1))
    keys = xs.path_keys(8, jnp.arange(30000, dtype=jnp.int32), 0)
    u = xs.uniform1(keys, 0)
    ch, _ = xs.sample_channel(vals, u)
    counts = np.bincount(np.asarray(ch), minlength=3) / 30000
    np.testing.assert_allclose(counts, [0.1, 0.3, 0.6], atol=0.01)


def test_discrete_distribution_1d_general():
    """General N-bin CDF container (Src/sampler.h:53-97): pmf, lower_bound
    semantics incl. the x==0 bump, and statistical agreement."""
    import numpy as np
    from xraytracer.sampling.distribution import DiscreteDistribution1D

    w = [1.0, 0.0, 3.0, 2.0, 4.0]
    d = DiscreteDistribution1D(w)
    np.testing.assert_allclose(np.asarray(d.pmf), np.asarray(w) / 10.0)
    # u = 0 bumps to the first bin (reference x==0 bump, Src/sampler.h:88-92)
    idx, p = d.sample(jnp.asarray([0.0]))
    assert int(idx[0]) == 0
    np.testing.assert_allclose(float(p[0]), 0.1, rtol=1e-6)
    # u just above a cdf edge lands in the next nonempty bin
    idx, _ = d.sample(jnp.asarray([0.1 + 1e-6]))
    assert int(idx[0]) == 2  # bin 1 has zero mass
    # u = 1 lands in the last bin
    idx, _ = d.sample(jnp.asarray([1.0]))
    assert int(idx[0]) == 4
    # frequencies converge to the pmf
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.random(200_000, dtype=np.float32))
    idx, _ = d.sample(u)
    freq = np.bincount(np.asarray(idx), minlength=5) / u.shape[0]
    np.testing.assert_allclose(freq, np.asarray(w) / 10.0, atol=5e-3)
    # all-zero weights: deliberate uniform fallback
    d0 = DiscreteDistribution1D([0.0, 0.0])
    np.testing.assert_allclose(np.asarray(d0.pmf), 0.5)
