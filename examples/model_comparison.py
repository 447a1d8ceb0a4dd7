"""Bayesian model comparison: constant vs linearly-evolving amplitude.

JAX port of the reference tutorial (docs/source/model_comparison.ipynb):
run the sampler once per model, compare evidences via the Bayes factor.
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import jax.numpy as jnp
import pocomc_tpu as pc

rng = np.random.default_rng(0)
params_true = np.array([0.5, 1.75, 50.0, 0.8])
t = np.sort(rng.uniform(0.0, 1.0, 100))
sigma = 0.5

t_j = jnp.asarray(t)


def model_extended(x, t):
    A, B, omega, phi = (x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4])
    return (A + B * t) * jnp.cos(omega * t + phi)


def model_simple(x, t):
    A, omega, phi = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return A * jnp.cos(omega * t + phi)


data = np.asarray(model_extended(params_true[None], t_j))[0] \
    + rng.normal(0, sigma, 100)
data_j = jnp.asarray(data)


def make_loglike(model):
    def log_likelihood(x):
        resid = model(x, t_j) - data_j
        return -0.5 * jnp.sum(resid**2, axis=-1) / sigma**2
    return log_likelihood


prior_extended = pc.Prior([pc.Uniform(-5.0, 5.0), pc.Uniform(-5.0, 5.0),
                           pc.Uniform(10.0, 100.0), pc.Uniform(0.0, np.pi)])
prior_simple = pc.Prior([pc.Uniform(-5.0, 5.0),
                         pc.Uniform(10.0, 100.0), pc.Uniform(0.0, np.pi)])

if __name__ == "__main__":
    results = {}
    for name, prior, model in (("extended", prior_extended, model_extended),
                               ("simple", prior_simple, model_simple)):
        s = pc.Sampler(prior, make_loglike(model), vectorize=True,
                       random_state=0)
        s.run()
        results[name] = s.evidence()
        print(f"{name}: logZ = {results[name][0]:.2f} +- {results[name][1]:.2f}")

    bf = np.exp(results["extended"][0] - results["simple"][0])
    print(f"\nBayes factor extended/simple: {bf:.3e}")
