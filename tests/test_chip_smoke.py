"""chip_smoke.py's parts that run without a card: the refusal of a CPU
backend, the contract's last line, phase selection, the comparison rules,
the float64 sweep reference, and each phase at a tiny size on the CPU
mesh (where "card" and CPU reference coincide, so only the plumbing and
the checks are exercised)."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_without_the_repository(tmp_path):
    """Alone in a directory the script cannot import the package: it exits
    non-zero before touching JAX and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_has_exactly_the_contract_keys():
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("argv,expect", [
    ([], ["device", "precision", "goldens", "cornell_gi", "nee", "train"]),
    (["--four-cards"], ["device", "four_cards"]),
])
def test_phase_selection(argv, expect):
    assert chip_smoke.phases(argv) == expect


def test_unknown_option_is_refused():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phases(["--cpu"])
    assert exc.value.code != 0


def _images(share_off, mean_shift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.1, 1.0, (1000, 3)).astype(np.float32)
    got = ref.copy()
    n = int(round(share_off * len(ref)))
    got[:n] *= 1.5
    return got * (1.0 + mean_shift), ref


@pytest.mark.parametrize("share_off,mean_shift,ok", [
    (0.0, 0.0, True),
    (0.001, 0.0, True),        # one flipped pixel in a thousand
    (0.02, 0.0, False),        # beyond the 1 % path-flip bound
    (0.0, 0.01, False),        # a 1 % systematic shift of every pixel
])
def test_compare_images_bounds(share_off, mean_shift, ok):
    got, ref = _images(share_off, mean_shift)
    if ok:
        _, share, _ = chip_smoke.compare_images(got, ref, "t")
        assert share == pytest.approx(share_off)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare_images(got, ref, "t")


def test_compare_images_rejects_non_finite():
    got, ref = _images(0.0)
    got[3, 1] = np.nan
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_images(got, ref, "t")


def test_float64_reference_matches_classic_sweep():
    from xraytracer.geometry import Rays
    from xraytracer.geometry.intersect import intersect_triangles
    from xraytracer.scene import SceneBuilder

    rng = np.random.default_rng(5)
    b = SceneBuilder()
    b.add_mesh(rng.uniform(-5, 5, (128, 3, 3)).astype(np.float32),
               material=b.add_lambert((1, 1, 1)))
    s = b.build()
    o = rng.uniform(-8, 8, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (s.tri_v0, s.tri_e1, s.tri_e2, s.tri_obj >= 0)
    t64, i64 = chip_smoke.mt_float64(o, d, *(np.asarray(a) for a in args),
                                     chunk=256)
    t, i, _, _ = jax.jit(intersect_triangles)(
        Rays(o=jnp.asarray(o), d=jnp.asarray(d)), *args)
    i = np.asarray(i)
    assert (i64 >= 0).any() and (i64 < 0).any()
    assert (i == i64).mean() > 0.99
    same = (i == i64) & (i >= 0)
    # random triangles hit at grazing angles: float32 keeps ~5 digits of t
    np.testing.assert_allclose(np.asarray(t)[same], t64[same], rtol=1e-4)


def test_sweep_phase_tiny():
    res = chip_smoke.sweep_phase(width=40, height=30)
    assert res["rays"] == 1200
    for name in ("mm", "classic"):
        assert res[name]["agree"] >= chip_smoke.SWEEP_MIN_AGREE
        assert res[name]["max_t_rel"] <= chip_smoke.SWEEP_T_RTOL


def test_cli_phase_tiny(tmp_path):
    res = chip_smoke.cli_phase("cornellbox_gi", 2, out_dir=str(tmp_path),
                               width=24, height=18, n_check=64)
    assert os.path.exists(os.path.join(tmp_path, "cornellbox_gi.png"))
    assert res["size"] == "24x18" and res["cpu_share_out"] == 0.0
    assert res["rays_per_s"] > 0


def test_train_phase_tiny():
    res = chip_smoke.train_phase(width=24, height=18, n_check=128)
    losses = res["losses"]
    assert len(losses) == 3 and losses[2] < losses[1] < losses[0]


def test_four_card_phase_on_virtual_cpus():
    devs = jax.devices()
    assert len(devs) >= 4  # conftest forces 8 virtual devices
    res = chip_smoke.four_card_phase(devs, width=16, height=8, spp=2)
    assert res["shard_share_out"] == 0.0
    assert res["psum_share_out"] == 0.0
    assert res["scaling_efficiency"] > 0.0
