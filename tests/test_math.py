import jax.numpy as jnp
import numpy as np
import pytest

from xraytracer import math as xm
from xraytracer.constants import PI


def rng(seed=0):
    return np.random.default_rng(seed)


def rand_unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_dot_cross_length():
    r = rng()
    a = r.normal(size=(64, 3)).astype(np.float32)
    b = r.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(xm.dot(a, b), np.sum(a * b, -1), rtol=1e-5)
    np.testing.assert_allclose(xm.cross(a, b), np.cross(a, b), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xm.length(a), np.linalg.norm(a, axis=-1), rtol=1e-5)


def test_normalize():
    r = rng()
    a = r.normal(size=(32, 3)).astype(np.float32) * 10
    n = np.asarray(xm.normalize(a))
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, rtol=1e-5)


def test_orthonormal_basis_properties():
    r = rng(1)
    n = rand_unit(r, 256)
    # include the tricky poles
    n = np.concatenate([n, [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0]]]).astype(
        np.float32
    )
    t, b = xm.orthonormal_basis(n)
    t, b = np.asarray(t), np.asarray(b)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(t * n, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(b * n, -1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.sum(t * b, -1), 0.0, atol=1e-5)


def test_reflect():
    i = np.array([[1.0, -1.0, 0.0]], dtype=np.float32) / np.sqrt(2)
    n = np.array([[0.0, 1.0, 0.0]], dtype=np.float32)
    out = np.asarray(xm.reflect(i, n))
    np.testing.assert_allclose(out, [[1 / np.sqrt(2), 1 / np.sqrt(2), 0]], atol=1e-6)


def test_refract_snell():
    # normal incidence passes straight through
    i = np.array([[0.0, -1.0, 0.0]], dtype=np.float32)
    n = np.array([[0.0, 1.0, 0.0]], dtype=np.float32)
    out = np.asarray(xm.refract(i, n, 1.5))
    np.testing.assert_allclose(out, i, atol=1e-6)
    # oblique: check Snell's law sin(theta_t) = sin(theta_i)/ior
    theta_i = 0.5
    i = np.array(
        [[np.sin(theta_i), -np.cos(theta_i), 0.0]], dtype=np.float32
    )
    out = np.asarray(xm.refract(i, n, 1.5))[0]
    sin_t = np.linalg.norm(np.cross(out, [0, 1, 0]))
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, rtol=1e-5)


def test_refract_tir_zero():
    # from dense to sparse at grazing angle -> TIR -> zero vector
    n = np.array([[0.0, 1.0, 0.0]], dtype=np.float32)
    i = np.array([[np.sin(1.4), np.cos(1.4), 0.0]], dtype=np.float32)  # exiting
    out = np.asarray(xm.refract(i, n, 1.5))
    np.testing.assert_allclose(out, 0.0, atol=1e-7)


def test_fresnel_limits():
    n = np.array([[0.0, 1.0, 0.0]], dtype=np.float32)
    # normal incidence: ((n-1)/(n+1))^2
    i = np.array([[0.0, -1.0, 0.0]], dtype=np.float32)
    kr = float(np.asarray(xm.fresnel(i, n, 1.5))[0])
    np.testing.assert_allclose(kr, ((1.5 - 1) / (1.5 + 1)) ** 2, rtol=1e-4)
    # TIR from inside
    i = np.array([[np.sin(1.4), np.cos(1.4), 0.0]], dtype=np.float32)
    kr = float(np.asarray(xm.fresnel(i, n, 1.5))[0])
    assert kr == pytest.approx(1.0)


def test_local_world_roundtrip():
    r = rng(2)
    n = rand_unit(r, 64)
    t, b = xm.orthonormal_basis(n)
    v = rand_unit(r, 64)
    loc = xm.world_to_local(v, t, n, b)
    back = xm.local_to_world(loc, t, n, b)
    np.testing.assert_allclose(np.asarray(back), v, atol=1e-5)


def test_transform_point_dir():
    # reference cornellbox camera matrix (Src/examples/cornellbox.cpp:28-32)
    m = xm.from_rows(
        -1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, -1.0, 0,
        278, 274.4, -750.0, 1,
    )
    p = jnp.array([[1.0, 2.0, 3.0]])
    out = np.asarray(xm.transform_point(m, p))[0]
    np.testing.assert_allclose(out, [277.0, 276.4, -753.0], rtol=1e-6)
    d = jnp.array([[0.0, 0.0, -1.0]])
    out = np.asarray(xm.transform_dir(m, d))[0]
    np.testing.assert_allclose(out, [0.0, 0.0, 1.0], atol=1e-7)


def test_inverse():
    m = xm.from_rows(
        0.95292, 0.289503, 0.0901785, 0,
        -0.0960954, 0.5704, -0.815727, 0,
        -0.287593, 0.768656, 0.571365, 0,
        1, 2, 3, 1,
    )
    mi = xm.inverse(m)
    np.testing.assert_allclose(np.asarray(m @ mi), np.eye(4), atol=1e-2)
