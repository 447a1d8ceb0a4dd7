"""Independent-MH mutation kernel (mcmc.py kind='imh') — global moves
proposed from the flow's latent base. Beyond-reference: zero
autocorrelation on accept, mode hopping on multimodal targets, and
works for black-box likelihoods (no gradients needed).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pocomc_tpu as pc


def _mixture(d=2, sep=4.0, sig=0.5, w1=0.6):
    m = np.full(d, sep)
    w2 = 1.0 - w1

    def loglike(x):
        l1 = -0.5 * jnp.sum((x - m) ** 2, axis=-1) / sig**2 \
             - d * jnp.log(np.sqrt(2 * np.pi) * sig)
        l2 = -0.5 * jnp.sum((x + m) ** 2, axis=-1) / sig**2 \
             - d * jnp.log(np.sqrt(2 * np.pi) * sig)
        return jnp.logaddexp(jnp.log(w1) + l1, jnp.log(w2) + l2)

    ps = 10.0
    var = sig**2 + ps**2
    z1 = w1 * np.exp(-0.5 * np.sum(m**2) / var) / (2 * np.pi * var) ** (d / 2)
    z2 = w2 * np.exp(-0.5 * np.sum(m**2) / var) / (2 * np.pi * var) ** (d / 2)
    prior = pc.Prior([pc.Normal(0, ps) for _ in range(d)])
    return loglike, prior, np.log(z1 + z2), z1 / (z1 + z2)


def test_imh_bimodal_mixture():
    """Mode mass and logZ on a bimodal target — the global-move kernel's
    home turf (measured at ~half the likelihood calls of tpcn here)."""
    loglike, prior, logz_true, mass1_true = _mixture()
    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   n_effective=512, n_active=256, sample="imh",
                   flow="nsf3", train_config={"epochs": 60, "patience": 8})
    s.run(n_total=1024, n_evidence=2048, progress=False)
    assert s.logz == pytest.approx(logz_true, abs=0.3)
    x, w, _, _ = s.posterior()
    mass1 = float(w[x[:, 0] > 0].sum() / w.sum())
    assert mass1 == pytest.approx(mass1_true, abs=0.1)


def test_imh_blackbox_likelihood():
    """imh needs no gradients: a plain-numpy (non-traceable) likelihood
    runs through the host-driven path."""
    def loglike(x):
        x = np.asarray(x)
        return -0.5 * np.sum(x**2, axis=-1) - x.shape[-1] / 2 * np.log(2 * np.pi)

    from scipy.stats import norm
    expect = 2 * norm.logpdf(0, 0, np.sqrt(26.0))
    prior = pc.Prior([pc.Normal(0, 5), pc.Normal(0, 5)])
    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   n_effective=256, n_active=128, sample="imh",
                   flow="nsf3", train_config={"epochs": 40, "patience": 5})
    assert not s.likelihood_traceable
    s.run(n_total=512, n_evidence=512, progress=False)
    assert s.logz == pytest.approx(expect, abs=0.4)


def test_imh_requires_preconditioning():
    with pytest.raises(ValueError, match="precondition"):
        pc.Sampler(pc.Prior([pc.Normal(0, 1), pc.Normal(0, 1)]),
                   lambda x: -jnp.sum(x**2, axis=-1), sample="imh",
                   precondition=False)

def test_imh_refresh_mixing_preserves_target_and_decorrelates():
    """imh_every (mixed kernel): end-to-end evidence/posterior stay
    correct on a known-answer Gaussian, and the refresh steps make the
    sweep reach the decorrelation target in fewer steps (the rationale:
    an accepted independence move erases walker memory outright)."""
    from scipy.stats import norm
    d = 4

    def loglike(x):
        return (-0.5 * jnp.sum(x**2, axis=-1)
                - d / 2 * jnp.log(2 * jnp.pi))

    expect = d * norm.logpdf(0, 0, np.sqrt(26.0))
    prior = pc.Prior([pc.Normal(0, 5) for _ in range(d)])
    calls = {}
    for ie in (0, 2):
        s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                       n_effective=256, n_active=128, imh_every=ie,
                       corr_threshold=0.1, flow="nsf3",
                       train_config={"epochs": 40, "patience": 5})
        assert s.imh_every == ie
        s.run(n_total=512, n_evidence=512, progress=False)
        assert s.logz == pytest.approx(expect, abs=0.4)
        calls[ie] = s.calls
    # no call blow-up from the mixed kernel. (At low d the tpcn cap is
    # already ~0.99 = near-independence, so refresh can't WIN much here;
    # its measured speedup regime is high-d sigma-capped sweeps —
    # gauss50 dose-response, RESULTS.md round 4 "independence refresh".)
    # Margin verified over seeds 0-4: ratio 0.74-1.40, median 0.89
    # (RESULTS.md round 5 test_imh postmortem) —
    # the drift-test MIN_CALIB_N guard in mcmc.py is what keeps
    # refresh-dominated windows from pinning hot=1 and doubling calls.
    assert calls[2] < 1.5 * calls[0]


def test_imh_every_validation_and_plain_space_noop():
    with pytest.raises(ValueError, match="imh_every"):
        pc.Sampler(pc.Prior([pc.Normal(0, 1), pc.Normal(0, 1)]),
                   lambda x: -jnp.sum(x**2, axis=-1), imh_every=-1)
    # precondition=False: the cadence is silently inert (plain-space
    # sweeps have no flow latent to refresh from)
    s = pc.Sampler(pc.Prior([pc.Normal(0, 1), pc.Normal(0, 1)]),
                   lambda x: -jnp.sum(x**2, axis=-1), vectorize=True,
                   imh_every=3, precondition=False)
    s.run(n_total=256, n_evidence=0, progress=False)
    assert np.isfinite(s.particles.compute_logw_and_logz(1.0)[1])
