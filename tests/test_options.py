"""Coverage for the remaining sampler knobs and utility APIs."""

import numpy as np
import jax.numpy as jnp
import pytest

import pocomc_tpu as pc
from pocomc_tpu.utils import validation, configure_threads


def gaussian_loglike(x):
    return -0.5 * jnp.sum(x**2, axis=-1) - jnp.log(2 * jnp.pi)


def make_prior():
    return pc.Prior([pc.Normal(0, 5), pc.Normal(0, 5)])


def test_train_frequency_gating():
    """train_frequency=3: the flow trains on iterations t%3==0 (plus the
    forced first/last); u_geometry serves the others."""
    s = pc.Sampler(make_prior(), gaussian_loglike, vectorize=True,
                   random_state=0, n_effective=256, n_active=128,
                   precondition=True, flow="nsf3", train_frequency=3,
                   train_config={"epochs": 10, "patience": 3})
    s.run(n_total=512, n_evidence=512, progress=False)
    logz, err = s.evidence()
    from scipy.stats import norm
    assert abs(logz - 2 * norm.logpdf(0, 0, np.sqrt(26))) < max(4 * err, 0.3)


def test_dynamic_false_and_uss_metric():
    s = pc.Sampler(make_prior(), gaussian_loglike, vectorize=True,
                   random_state=0, n_effective=256, n_active=128,
                   precondition=False, dynamic=False, metric="uss")
    n_eff_before = s.n_effective
    s.run(n_total=512, n_evidence=0, progress=False)
    assert s.n_effective == n_eff_before  # dynamic off -> untouched


def test_custom_n_prior_and_n_steps():
    s = pc.Sampler(make_prior(), gaussian_loglike, vectorize=True,
                   random_state=0, n_effective=256, n_active=128,
                   precondition=False, n_prior=512, n_steps=4,
                   n_max_steps=8)
    assert s.n_prior == 512 and s.n_steps == 4 and s.n_max_steps == 8
    s.run(n_total=256, n_evidence=0, progress=False)
    assert max(s.particles.get("steps")) <= 8


def test_likelihood_args_kwargs():
    def loglike(x, scale, offset=0.0):
        return -0.5 * jnp.sum((x - offset)**2, axis=-1) / scale**2

    s = pc.Sampler(make_prior(), loglike, vectorize=True, random_state=0,
                   n_effective=128, n_active=64, precondition=False,
                   likelihood_args=[1.0], likelihood_kwargs={"offset": 0.0})
    s.run(n_total=256, n_evidence=0, progress=False)
    assert np.isfinite(s.evidence()[0])


def test_n_ess_deprecation():
    with pytest.warns(DeprecationWarning):
        s = pc.Sampler(make_prior(), gaussian_loglike, vectorize=True,
                       n_ess=256, n_active=128)
    assert s.n_effective == 256


def test_validation_helpers():
    validation.assert_array_2d(np.zeros((2, 2)))
    validation.assert_array_1d(np.zeros(3))
    validation.assert_array_float(np.zeros(3))
    validation.assert_array_finite(np.zeros(3))
    validation.assert_array_within_interval(np.array([0.5]), 0.0, 1.0)
    for bad in ((validation.assert_array_2d, np.zeros(3)),
                (validation.assert_array_1d, np.zeros((2, 2))),
                (validation.assert_array_float, np.zeros(3, dtype=int)),
                (validation.assert_array_finite, np.array([np.inf])),
                ):
        with pytest.raises(ValueError):
            bad[0](bad[1])
    with pytest.raises(ValueError):
        validation.assert_array_within_interval(np.array([2.0]), 0.0, 1.0)


def test_validation_wired_into_public_inputs():
    """The assert helpers guard the real input paths, not just exist
    (reference wires input_validation into scaler/sampler)."""
    from pocomc_tpu.scaler import Reparameterize

    # scaler.fit: non-finite and non-2-D fits must fail eagerly
    bounds = np.array([[-np.inf, np.inf]] * 2)
    sc = Reparameterize(2, bounds)
    with pytest.raises(ValueError):
        sc.fit(np.array([[0.0, np.nan]]))
    with pytest.raises(ValueError):
        sc.fit(np.zeros(5))

    # sampler __init__: a duck-typed prior with malformed bounds fails
    # at construction with a shape-naming error
    class BadBoundsPrior:
        dim = 2
        bounds = np.zeros(4)  # not (dim, 2)

        def logpdf(self, x):
            return np.zeros(len(np.atleast_2d(x)))

        def rvs(self, size=1):
            return np.random.rand(size, 2)

    with pytest.raises(ValueError, match="2-D|bounds"):
        pc.Sampler(BadBoundsPrior(), gaussian_loglike, vectorize=True,
                   n_effective=128, n_active=64)

    class WrongShapeBoundsPrior(BadBoundsPrior):
        bounds = np.zeros((3, 2))  # 2-D but wrong first axis

    with pytest.raises(ValueError, match="bounds"):
        pc.Sampler(WrongShapeBoundsPrior(), gaussian_loglike,
                   vectorize=True, n_effective=128, n_active=64)


def test_pipeline_option():
    """pipeline=0 (strict per-iteration sync) and default pipelined runs
    both recover the analytic evidence; invalid depths raise."""
    from scipy.stats import norm
    expect = 2 * norm.logpdf(0, 0, np.sqrt(1 + 25.0))
    for pl in (0, 2):
        s = pc.Sampler(make_prior(), gaussian_loglike, vectorize=True,
                       random_state=0, n_effective=256, n_active=128,
                       precondition=False, pipeline=pl)
        s.run(n_total=512, n_evidence=0, progress=False)
        logz = float(s.particles.compute_logw_and_logz(1.0)[1])
        assert logz == pytest.approx(expect, abs=0.3), (pl, logz)
    with pytest.raises(ValueError, match="pipeline"):
        pc.Sampler(make_prior(), gaussian_loglike, pipeline=-1)
    with pytest.raises(ValueError, match="pipeline"):
        pc.Sampler(make_prior(), gaussian_loglike, pipeline=1.5)


def test_configure_threads_noop():
    configure_threads(pytorch_threads=1)  # accepted, ignored
    configure_threads(blas_threads=1)


def test_extra_distributions_sample_and_logpdf():
    import jax
    from scipy import stats
    pairs = [
        (pc.LogUniform(1.0, 100.0), stats.loguniform(1.0, 100.0)),
        (pc.Exponential(0.0, 2.0), stats.expon(0.0, 2.0)),
        (pc.HalfNormal(0.0, 1.5), stats.halfnorm(0.0, 1.5)),
        (pc.Laplace(0.0, 2.0), stats.laplace(0.0, 2.0)),
    ]
    for jd, sd in pairs:
        xs = np.asarray(jd.sample(jax.random.key(0), 2000))
        lo, hi = jd.support()
        assert (xs >= lo - 1e-6).all() and (xs <= hi + 1e-6).all()
        pts = np.asarray(sd.rvs(size=20, random_state=0), dtype=np.float64)
        np.testing.assert_allclose(np.asarray(jd.logpdf(jnp.asarray(pts))),
                                   sd.logpdf(pts), rtol=1e-4, atol=1e-4)


def _worker_platform(_):
    import os
    import jax
    return os.environ.get("JAX_PLATFORMS"), jax.default_backend()


def _np_gauss(x):
    return float(-0.5 * np.sum(np.asarray(x) ** 2))


def test_int_pool_workers_start_cpu_only():
    # pool=<int> workers must never open the accelerator: one that
    # unpickles a device array would reserve most of the card's memory
    import os
    before = os.environ.get("JAX_PLATFORMS")
    prior = pc.Prior([pc.Normal(0, 3)] * 2)
    s = pc.Sampler(prior, _np_gauss, pool=2, random_state=0,
                   n_effective=64, n_active=32, precondition=False)
    try:
        assert s.pool.map(_worker_platform, range(4)) == [("cpu", "cpu")] * 4
    finally:
        s.pool.terminate()
        s.pool.join()
    assert os.environ.get("JAX_PLATFORMS") == before
