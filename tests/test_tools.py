"""Offline tools: grid converter and majorant analysis."""

import os

import numpy as np


def test_grid_convert_procedural_roundtrip(tmp_path):
    from xraytracer.tools.grid_convert import main

    out = os.path.join(tmp_path, "g.npy")
    main(["procedural", out, "--res", "16"])
    g = np.load(out)
    assert g.shape == (16, 16, 16) and g.dtype == np.float32
    assert g.max() <= 1.0 and g.min() >= 0.0 and (g > 0).any()


def test_majorant_stats_constant_grid():
    """On a constant grid the block-max majorant is EXACT (efficiency 1)
    and the residual majorant vanishes."""
    from xraytracer.tools.majorant_stats import chord_integrals

    dens = np.full((16, 16, 16), 0.4, np.float32)
    r = chord_integrals(dens, nb=4, n_chords=200, n_samples=64)
    np.testing.assert_allclose(r["max_majorant"], r["true"], rtol=1e-5)
    assert r["residual"] < 1e-6
    assert r["true"] > 0.0


def test_majorant_stats_orders_majorants():
    """On a structured grid: true <= residual-implied work and
    true <= max-majorant; finer supergrids tighten the max majorant."""
    from xraytracer.tools.majorant_stats import chord_integrals

    rng = np.random.default_rng(0)
    base = rng.uniform(0.0, 1.0, (4, 4, 4)).astype(np.float32)
    dens = np.kron(base, np.ones((4, 4, 4), np.float32))  # blocky 16^3
    r4 = chord_integrals(dens, nb=4, n_chords=300)
    r8 = chord_integrals(dens, nb=8, n_chords=300)
    assert r4["true"] <= r4["max_majorant"] + 1e-5
    assert r8["max_majorant"] <= r4["max_majorant"] + 1e-5
    assert r4["residual"] <= r4["max_majorant"] + 1e-5


def test_fit_scene_step_lowers_loss():
    """One Adam step of tools/fit_scene from the blind start lowers the
    loss of that step's own sample stream."""
    from xraytracer.tools.fit_scene import make_problem

    prob = make_problem(width=12, height=9, spp=1, target_spp=4)
    l0 = float(prob.loss(prob.params0, 0))
    _, params, _ = prob.step(prob.params0, prob.opt_state0, 0)
    l1 = float(prob.loss(params, 0))
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (l0, l1)


def test_fit_volume_step_lowers_loss():
    """One step of tools/fit_volume (reverse mode through the bounded
    tracking loops, score-corrected, two-sample product loss) lowers the
    loss averaged over a block of sample streams."""
    import jax

    from xraytracer.tools.fit_volume import make_problem

    prob = make_problem(width=8, height=6, lr=0.3, steps=4, max_depth=1,
                        pairs=1, target_pairs=4, res=4, max_steps=8)

    def avg_loss(z):
        # ``step`` returns the loss at its input, before the update
        return float(np.mean([prob.step(z, prob.opt_state0, s)[0]
                              for s in range(8)]))

    l0 = avg_loss(prob.z0)
    _, z1, _ = prob.step(prob.z0, prob.opt_state0, 0)
    l1 = avg_loss(z1)
    assert np.isfinite(np.asarray(jax.nn.sigmoid(z1))).all()
    assert l1 < l0, (l0, l1)
