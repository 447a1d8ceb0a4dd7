"""Checkpointing: save state files during a run, resume, and extend.

JAX port of the reference checkpoint tutorial
(docs/source/checkpoint.ipynb).
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import jax.numpy as jnp
import pocomc_tpu as pc

prior = pc.Prior([pc.Normal(0, 5) for _ in range(4)])


def log_likelihood(x):
    return -0.5 * jnp.sum(x**2, axis=-1)


if __name__ == "__main__":
    # Save a state file every 2 iterations to ./states
    sampler = pc.Sampler(prior, log_likelihood, vectorize=True,
                         random_state=0, output_dir="states",
                         output_label="demo")
    sampler.run(n_total=1024, n_evidence=0, save_every=2)
    print("final iterations:", sampler.t)

    # Resume from an intermediate state — and extend the run with a larger
    # n_total ("Load and Add More Samples")
    sampler2 = pc.Sampler(prior, log_likelihood, vectorize=True,
                          random_state=1)
    sampler2.run(n_total=4096, n_evidence=1024,
                 resume_state_path="states/demo_final.state")
    print("extended to:", sampler2.t, "evidence:", sampler2.evidence())
