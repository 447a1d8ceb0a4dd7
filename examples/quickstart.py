"""Quickstart: sample the 10-D Rosenbrock distribution.

JAX port of the reference quickstart (docs/source/quickstart.ipynb):
the likelihood is written in JAX so it compiles straight into the sampler's
fused MCMC sweeps.
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import jax.numpy as jnp
import pocomc_tpu as pc

n_dim = 10

# N(0, 3) prior on every parameter
prior = pc.Prior([pc.Normal(0.0, 3.0) for _ in range(n_dim)])


def log_likelihood(x):
    """10-D Rosenbrock over even/odd pairs (vectorized, traceable)."""
    return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                    + (x[..., ::2] - 1.0) ** 2, axis=-1)


if __name__ == "__main__":
    sampler = pc.Sampler(prior, log_likelihood, vectorize=True,
                         random_state=0)
    sampler.run(n_total=4096, n_evidence=4096)

    samples, weights, logl, logp = sampler.posterior()
    logz, logz_err = sampler.evidence()
    print(f"\nlogZ = {logz:.3f} +- {logz_err:.3f}")
    mean = (weights[:, None] * samples).sum(0) / weights.sum()
    print("posterior mean:", mean.round(3))
