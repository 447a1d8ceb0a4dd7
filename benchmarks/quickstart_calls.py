"""Quickstart calls A/B at corr_threshold in (0, 0.5, 0.75) with the
max-over-dims u-space decorrelation probe."""
import sys, time
import numpy as np
import jax.numpy as jnp
import pocomc_tpu as pc
from pocomc_tpu.utils.tools import enable_compile_cache
enable_compile_cache()

def log_like(x):
    return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                    + (x[..., ::2] - 1.0) ** 2, axis=-1)

prior = pc.Prior([pc.Normal(0.0, 3.0) for _ in range(10)])

def one(seed, corr):
    s = pc.Sampler(prior, log_like, vectorize=True, random_state=seed,
                   corr_threshold=corr)
    t0 = time.perf_counter()
    s.run(progress=False)
    steps = [d["steps"] for d in s._dev_iter_stats]
    return (time.perf_counter() - t0, s.logz, s.calls, s.t,
            float(np.mean(steps)), s.evidence_khat)

for corr in (0.0, 0.5, 0.75):
    one(0, corr)  # warm this program
    rows = [one(seed, corr) for seed in (1, 2, 3, 4, 5)]
    walls, logzs, calls, ts, steps, khats = zip(*rows)
    print(f"corr={corr}: wall {np.median(walls):.2f}s  "
          f"logz med {np.median(logzs):.3f}  calls {[int(c) for c in calls]} "
          f"(median {int(np.median(calls))})  "
          f"mean-steps {np.round(steps,1).tolist()}  "
          f"khat {np.round(khats,2).tolist()}", flush=True)
