"""Mechanism probes for the SMC-ladder rung bias (round-4 follow-up).

Runs OFFLINE on histories saved by ladder_estimators.py
(states/<cfg>_s0_hist.npz) and answers three mechanism questions the
round-4 estimator zoo raised; results recorded in RESULTS.md round 4
"corrlaw postmortem":

1. finite-n? Re-lay the causal rung recursion on half the particle
   columns. If the final-error doubles, the bias is a finite-n recursion
   artifact and Richardson extrapolation (2*full - half) removes it.
   MEASURED: half-n error is IDENTICAL to full-n (quickstart +0.50 vs
   +0.51, gauss50 +0.39 vs +0.39) - not finite-n; Richardson dead.

2. exact duplicates? Count stage rows whose logl already appears in the
   previous stage / any earlier stage (never-moved resample copies).
   MEASURED: gauss50 carries ~0.2% exact duplicates yet +0.30 of rung
   bias - the carrier is PARTIAL walker memory (corr_exit ~ 0.08), not
   literal copies; dedup-style repairs have nothing to remove.

3. corr-law correction (hot = corr_exit * dbeta * Var(logl), the
   round-3 dose-response law turned into a per-rung retro correction)?
   MEASURED: fixes exactly the configs whose bias is rung-driven
   (gauss50 ct=0.15: +0.301 -> -0.051 vs oracle-rung -0.001) but with a
   config-dependent scale (quickstart +0.475 -> -0.443, ~2x overshoot)
   and DESTROYS coverage-dominated configs whose ladder is already too
   low (rosenbrock -0.895 -> -2.009, corrlaw/2 -1.449). Any uniformly
   positive hotness correction must hurt curved-negative configs; the
   in-sample discriminator does not exist (round-4 five-negative-result
   search). NOT shipped as a default.

Usage: python benchmarks/ladder_mechanism_probes.py [config ...]
"""
import sys
import numpy as np

EXACT = {"quickstart": -21.4021, "gauss50": -276.576,
         "rosenbrock10": -50.033, "cosmo30": None, "funnel25": None}


def relay_ladder(logl, beta, hot=None):
    """Causal re-lay of the engine's rung recursion (the math of
    Particles.recorrected_logz): rung t = MIS logmeanexp over stages <t
    with the already-laid rungs in the mixture denominators, minus
    dbeta_t * hot_{t-1}."""
    T, n = logl.shape
    if hot is None:
        hot = np.zeros(T)
    logz = np.zeros(T)
    denom = None
    with np.errstate(invalid="ignore"):
        for t in range(1, T):
            comp = beta[t - 1] * logl[:t] - logz[t - 1]
            if denom is None:
                denom = comp
            else:
                nb = (beta[:t - 1, None] * logl[t - 1][None, :]
                      - logz[:t - 1, None])
                m = np.max(nb, axis=0)
                nb = m + np.log(np.sum(np.exp(nb - m), axis=0))
                denom = np.logaddexp(np.vstack([denom, nb]), comp)
            if beta[t] == beta[t - 1]:
                logz[t] = logz[t - 1]
                continue
            lw = beta[t] * logl[:t] - (denom - np.log(t))
            m = np.max(lw)
            logz[t] = (m + np.log(np.sum(np.exp(lw - m))) - np.log(t * n)
                       - (beta[t] - beta[t - 1]) * hot[t - 1])
    return logz


def final_mis(logl, beta, f, beta_final=1.0):
    T, n = logl.shape
    ll = logl.reshape(-1)
    A = beta[:, None] * ll[None, :] - f[:, None]
    m = A.max(axis=0)
    B = m + np.log(np.sum(np.exp(A - m), axis=0)) - np.log(T)
    lw = beta_final * ll - B
    mm = lw.max()
    return mm + np.log(np.sum(np.exp(lw - mm))) - np.log(T * n)


def padfront(a, T):
    a = np.asarray(a, np.float64)
    return np.concatenate([np.zeros(T - a.size), a]) if a.size < T else a


def probe(cfg):
    d = np.load(f"states/{cfg}_s0_hist.npz")
    logl = np.asarray(d["logl"], np.float64)
    beta = np.asarray(d["beta"], np.float64)
    T, n = logl.shape
    exact = EXACT.get(cfg)
    if exact is None and "expect" in d:
        exact = float(d["expect"])
    corr = padfront(d["corr"], T)
    resid = padfront(d["resid_exit"], T)
    print(f"== {cfg}  T={T} n={n}  exact {exact}")

    err = lambda v: f"{v:+.3f}" if exact is None else f"err {v-exact:+.3f}"

    # 1. half-n probe
    full = final_mis(logl, beta, relay_ladder(logl, beta))
    rng = np.random.default_rng(0)
    halves = []
    for _ in range(4):
        cols = rng.permutation(n)
        for half in (cols[:n // 2], cols[n // 2:]):
            lh = logl[:, half]
            halves.append(final_mis(lh, beta, relay_ladder(lh, beta)))
    print(f"  relaid full-n {full:.3f} {err(full)}   half-n mean "
          f"{np.mean(halves):.3f} {err(np.mean(halves))} "
          f"(sd {np.std(halves):.3f})")

    # 2. duplicate census
    dup_prev = [np.mean([v in set(logl[t - 1].tolist())
                         for v in logl[t]]) for t in range(1, T)]
    print(f"  exact-duplicate frac vs prev stage: median "
          f"{np.median(dup_prev):.3f} max {np.max(dup_prev):.3f}   "
          f"corr_exit median {np.median(corr[corr > 0]) if (corr > 0).any() else 0:.3f}")

    # 3. corr-law / retro corrections
    dbeta = np.diff(beta, prepend=beta[0])
    var = np.var(logl, axis=1)
    hot_corr = np.clip(corr, 0, None) * np.clip(dbeta, 0, None) * var
    for name, hot in (("retro(-resid)", -resid), ("corrlaw", hot_corr),
                      ("corrlaw/2", 0.5 * hot_corr)):
        v = final_mis(logl, beta, relay_ladder(logl, beta, hot))
        print(f"  {name:14s} {v:.3f} {err(v)}")


if __name__ == "__main__":
    for cfg in (sys.argv[1:] or ["quickstart", "gauss50", "rosenbrock10"]):
        probe(cfg)
