"""Flow tests: bijection round-trips, ladj antisymmetry, densities,
sampling, and training (mirrors the invariants of reference
tests/test_flow.py:16-205 plus a density-accuracy check it lacks)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pocomc_tpu.models.flow import Flow


def make_data(n=128, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(n, d)), dtype=jnp.float32)


@pytest.mark.parametrize("arch", ["maf3", "nsf3", "nsfc3"])
class TestBijection:
    def test_forward_shapes_finite(self, arch):
        x = make_data()
        flow = Flow(4, arch)
        z, ladj = flow.forward(x)
        assert z.shape == x.shape and ladj.shape == (x.shape[0],)
        assert np.isfinite(np.asarray(z)).all()
        assert np.isfinite(np.asarray(ladj)).all()

    def test_roundtrip(self, arch):
        x = make_data()
        flow = Flow(4, arch, seed=1)
        # train briefly so the map is non-trivial
        flow.fit(x, epochs=3, batch_size=64, verbose=0)
        z, _ = flow.forward(x)
        x_r, _ = flow.inverse(z)
        np.testing.assert_allclose(np.asarray(x_r), np.asarray(x),
                                   rtol=1e-3, atol=1e-3)

    def test_ladj_antisymmetry(self, arch):
        x = make_data(n=32)
        flow = Flow(4, arch, seed=2)
        flow.fit(x, epochs=3, batch_size=32, verbose=0)
        z, ladj_fwd = flow.forward(x)
        _, ladj_inv = flow.inverse(z)
        np.testing.assert_allclose(np.asarray(ladj_fwd), -np.asarray(ladj_inv),
                                   rtol=1e-2, atol=1e-2)

    def test_identity_at_init(self, arch):
        # zero-init output layers -> identity map at construction
        x = make_data(n=16)
        flow = Flow(4, arch)
        z, ladj = flow.forward(x)
        np.testing.assert_allclose(np.asarray(z), np.asarray(x), atol=1e-5)
        np.testing.assert_allclose(np.asarray(ladj), np.zeros(16), atol=1e-5)

    def test_log_prob_shape(self, arch):
        x = make_data()
        flow = Flow(4, arch)
        lp = flow.log_prob(x)
        assert lp.shape == (x.shape[0],)
        assert np.isfinite(np.asarray(lp)).all()

    def test_sample(self, arch):
        flow = Flow(4, arch)
        x, logq = flow.sample(256, key=jax.random.key(0))
        assert x.shape == (256, 4) and logq.shape == (256,)
        assert np.isfinite(np.asarray(x)).all()

    def test_sample_logq_consistent_with_log_prob(self, arch):
        flow = Flow(4, arch, seed=3)
        x, logq = flow.sample(64, key=jax.random.key(1))
        lp = flow.log_prob(x)
        np.testing.assert_allclose(np.asarray(logq), np.asarray(lp),
                                   rtol=1e-3, atol=1e-3)

    def test_sample_t_density_normalized(self, arch):
        """t-latent proposal draws (models/flow.py sample_t): the
        returned logq must be the exact pushforward density, so the
        importance identity E_q[flow_density / q] = 1 must hold to MC
        error. flow_density is the flow's own log_prob — both densities
        ride the same transform, so the check reduces to the latent
        N(0,I)-vs-t_nu ratio under t_nu draws (finite moments, stable
        at modest n)."""
        flow = Flow(4, arch, seed=3)
        x, logq = jax.jit(flow._sample_t, static_argnums=(2,))(
            flow.params, jax.random.key(2), 4096, 5.0)
        lp = flow.log_prob(x)
        w = np.exp(np.asarray(lp) - np.asarray(logq))
        assert np.isfinite(w).all()
        assert np.mean(w) == pytest.approx(1.0, abs=0.05)
        # heavier base: the ratio never explodes (tail draws are the
        # DENOMINATOR's heavy side)
        assert w.max() < 10.0


def test_identity_log_prob_is_standard_normal():
    x = make_data(n=16)
    flow = Flow(4, "nsf3")
    lp = np.asarray(flow.log_prob(x))
    expect = -0.5 * np.sum(np.asarray(x) ** 2, axis=1) - 2 * np.log(2 * np.pi)
    np.testing.assert_allclose(lp, expect, rtol=1e-4, atol=1e-4)


def test_fit_improves_nll():
    rng = np.random.default_rng(5)
    # correlated, shifted Gaussian
    A = np.array([[1.0, 0.0], [0.8, 0.5]])
    x = jnp.asarray(rng.normal(size=(512, 2)) @ A.T + 2.0, dtype=jnp.float32)
    flow = Flow(2, "maf3", seed=4)
    nll_before = -float(jnp.mean(flow.log_prob(x)))
    hist = flow.fit(x, epochs=200, batch_size=128, patience=20,
                    validation_split=0.0, verbose=0, seed=0)
    nll_after = -float(jnp.mean(flow.log_prob(x)))
    assert nll_after < nll_before - 0.5
    assert len(hist["loss"]) >= 1


def test_fit_weighted_and_early_stop():
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(256, 3)), dtype=jnp.float32)
    w = jnp.asarray(rng.random(256), dtype=jnp.float32)
    flow = Flow(3, "nsf3", seed=5)
    hist = flow.fit(x, weights=w, epochs=5000, batch_size=64, patience=3,
                    validation_split=0.5, verbose=0, seed=0)
    # early stopping must fire long before 5000 epochs
    assert len(hist["loss"]) < 1000
    assert np.isfinite(hist["loss"]).all()


def test_invalid_arch_raises():
    with pytest.raises(ValueError):
        Flow(2, "bogus")


@pytest.mark.parametrize("flag", ["use_pallas", "use_pallas_inverse"])
def test_removed_pallas_flags_raise(flag):
    # the Pallas kernels behind these flags were deleted; configs that
    # still pass them must fail loudly instead of being silently ignored
    with pytest.raises(TypeError):
        Flow(3, "nsf3", **{flag: True})
