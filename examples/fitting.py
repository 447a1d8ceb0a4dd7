"""Bayesian model fitting: cosine signal with linearly-evolving amplitude.

JAX port of the reference fitting tutorial
(docs/source/fitting.ipynb): 4 parameters, 100 data points, uniform
priors. The likelihood is vectorized over the particle batch so the whole
residual computation is one (n_particles, n_data) broadcast on device.
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import jax.numpy as jnp
import pocomc_tpu as pc

rng = np.random.default_rng(0)

# simulated data
params_true = np.array([0.5, 1.75, 50.0, 0.8])
t = np.sort(rng.uniform(0.0, 1.0, 100))
sigma = 0.5


def model(params, t):
    A, B, omega, phi = (params[..., 0:1], params[..., 1:2],
                        params[..., 2:3], params[..., 3:4])
    return (A + B * t) * jnp.cos(omega * t + phi)


data = np.asarray(model(params_true[None], t))[0] + rng.normal(0, sigma, 100)
t_j = jnp.asarray(t)
data_j = jnp.asarray(data)


def log_likelihood(x):
    resid = model(x, t_j) - data_j           # (n_particles, n_data)
    return -0.5 * jnp.sum(resid**2, axis=-1) / sigma**2


prior = pc.Prior([
    pc.Uniform(-5.0, 5.0),      # A
    pc.Uniform(-5.0, 5.0),      # B
    pc.Uniform(10.0, 110.0),    # omega
    pc.Uniform(0.0, np.pi),     # phi
])

if __name__ == "__main__":
    sampler = pc.Sampler(prior, log_likelihood, vectorize=True,
                         random_state=0)
    sampler.run()
    samples, weights, logl, logp = sampler.posterior()
    logz, logz_err = sampler.evidence()
    mean = (weights[:, None] * samples).sum(0) / weights.sum()
    print(f"\nlogZ = {logz:.3f} +- {logz_err:.3f}")
    print("posterior mean:", mean.round(3), "true:", params_true)
