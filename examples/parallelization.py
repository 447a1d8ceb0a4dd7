"""Parallel likelihood evaluation.

The reference parallelizes scalar likelihood calls over process/MPI pools
(docs/source/parallelization.ipynb). On GPUs the preferred route is the
device mesh — particles shard over the cards and the (JAX) likelihood
runs SPMD — with host pools kept for black-box Python likelihoods.
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import jax.numpy as jnp
import pocomc_tpu as pc
from pocomc_tpu.parallel import ParticleMesh

prior = pc.Prior([pc.Normal(0, 5) for _ in range(4)])


def log_likelihood(x):          # JAX, vectorized -> compiles into the sweep
    return -0.5 * jnp.sum(x**2, axis=-1)


def log_likelihood_blackbox(x):  # plain numpy, one particle at a time
    return float(-0.5 * np.sum(x**2))


if __name__ == "__main__":
    # 1. Device-mesh parallelism (all visible chips; multi-host works after
    #    jax.distributed.initialize()):
    sampler = pc.Sampler(prior, log_likelihood, vectorize=True,
                         mesh=ParticleMesh(), random_state=0)
    sampler.run(n_total=1024, n_evidence=1024)
    print("mesh:", sampler.evidence())

    # 2. Host process pool for black-box likelihoods (reference pool=N):
    sampler = pc.Sampler(prior, log_likelihood_blackbox, pool=2,
                         random_state=0, precondition=False)
    sampler.run(n_total=512, n_evidence=0)
    print("pool:", sampler.evidence())

    # 3. MPI across nodes: run under mpiexec with
    #    with pc.MPIPool() as pool:
    #        sampler = pc.Sampler(prior, log_likelihood_blackbox, pool=pool)
