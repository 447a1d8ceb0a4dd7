"""Blobs: per-particle auxiliary data returned by the likelihood.

JAX port of the reference blobs example (docs/source/blobs.ipynb):
a scalar (host) likelihood returning extra values that are stored as a
structured array alongside the samples.
"""

import sys as _sys
import pathlib as _pathlib
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))


import numpy as np
import pocomc_tpu as pc

prior = pc.Prior([pc.Normal(0, 5) for _ in range(5)])


def log_likelihood(x):
    return -0.5 * np.dot(x, x), np.median(x), int(np.sum(x > 0))


if __name__ == "__main__":
    sampler = pc.Sampler(
        prior, log_likelihood,
        blobs_dtype=[("median", float), ("n_positive", int)],
        random_state=0)
    sampler.run()

    samples, weights, logl, logp, blobs = sampler.posterior(return_blobs=True)
    print("Median:", blobs["median"][:3])
    print("Number of positive parameters:", blobs["n_positive"][:3])
    logz, logz_err = sampler.evidence()
    print(f"logZ = {logz:.3f} +- {logz_err:.3f}")
