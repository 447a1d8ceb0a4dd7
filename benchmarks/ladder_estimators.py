"""SMC-ladder evidence estimator zoo (round-4 experiment).

Runs a north-star config, then evaluates candidate persistent-sampling
evidence estimators OFFLINE on the stored history, against the analytic
truth:

  raw     : causal ladder + full-history MIS (reference particles.py:
            215-231 semantics; what compute_logw_and_logz(1.0) returns)
  retro   : retroactively re-laid rung ladder using per-stage exit resid
            (Particles.recorrected_logz)
  mbar    : self-consistent multistate reweighting (MBAR, Shirts &
            Chodera 2008): iterate the balance-heuristic free energies
            to their fixed point instead of using the causal rungs in
            the denominators. Anchored at beta=0 (prior, logZ=0 exact).
  mbar*   : MBAR over TILTED states beta*_s = beta_s - resid_s / Var_s:
            a still-relaxing (selection-hot) stage population has
            E[logl] = E_{beta_s}[logl] - resid_s, which to first order
            matches the tempered family at a higher inverse temperature
            (dE/dbeta = Var_beta(logl)). MIS only needs the mixture to
            describe where samples ACTUALLY came from, so tilting the
            denominator states — not correcting the rungs — is the
            principled repair for hot stages.
  tilt    : one-shot tilted balance heuristic (no MBAR iteration):
            stored causal rung logz in the denominators, but components
            evaluated at beta*_s.

Usage: python benchmarks/ladder_estimators.py [config ...] (same config
names as baseline_configs.py).
"""
import os
import sys
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import baseline_configs as bc
import ladder_oracles


def _logsumexp(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else float(out)


def mis_logz(logl, beta_states, f_states, beta_final=1.0):
    """Balance-heuristic MIS logZ(beta_final) given mixture states."""
    T, n = logl.shape
    ll = logl.reshape(-1)
    A = beta_states[:, None] * ll[None, :] - f_states[:, None]
    B = _logsumexp(A, axis=0) - np.log(T)
    return _logsumexp(beta_final * ll - B) - np.log(T * n)


def mbar(logl, beta_states, f_init, iters=500, tol=1e-9):
    """Self-consistent MBAR free energies over the given states."""
    T, n = logl.shape
    ll = logl.reshape(-1)
    f = np.asarray(f_init, dtype=np.float64).copy()
    f -= f[0]
    E = beta_states[:, None] * ll[None, :]        # (T, Tn) state energies
    for _ in range(iters):
        B = _logsumexp(E - f[:, None], axis=0) - np.log(T)
        newf = _logsumexp(E - B[None, :], axis=1) - np.log(T * n)
        newf -= newf[0]
        delta = np.max(np.abs(newf - f))
        f = newf
        if delta < tol:
            break
    return f


def evaluate(s, expect, oracle=None, save_as=None):
    p = s.particles
    logl = np.asarray(p.past["logl"], dtype=np.float64)
    beta = np.asarray(p.past["beta"], dtype=np.float64)
    logz = np.asarray(p.past["logz"], dtype=np.float64)
    resid = np.asarray(p.past.get("resid_exit") or [], dtype=np.float64)
    T, n = logl.shape
    if resid.size < T:  # warmup stages predate the sweep diagnostics
        resid = np.concatenate([np.zeros(T - resid.size), resid])
    if save_as:
        os.makedirs("states", exist_ok=True)
        corr_s = np.asarray(p.past.get("corr") or [], dtype=np.float64)
        np.savez(f"states/{save_as}_hist.npz", logl=logl, beta=beta,
                 logz=logz, resid_exit=resid, corr=corr_s,
                 expect=expect)

    raw = p.compute_logw_and_logz(1.0)[1]
    retro_logz = p.recorrected_logz()
    retro = mis_logz(logl, beta, retro_logz)

    # corr-law hotness: per-rung bias ~ corr_exit * dbeta * Var(logl)
    # (the measured gauss50 ladder-bias law, RESULTS.md round 3
    # "decorrelation dose-response": bias per rung ~ corr_exit * s^2
    # with s^2 = Var(dbeta*logl) pinned by the ESS bisection target)
    corr = np.asarray(p.past.get("corr") or [], dtype=np.float64)
    if corr.size < T:
        corr = np.concatenate([np.zeros(T - corr.size), corr])
    dbeta = np.diff(beta, prepend=beta[0])
    var = np.var(logl, axis=1)
    hot_corr = np.clip(corr, 0.0, None) * np.clip(dbeta, 0.0, None) * var
    corrlaw = mis_logz(logl, beta, p.recorrected_logz(hot=hot_corr))
    # combined: whichever hotness estimate is larger per stage
    hot_comb = np.maximum(hot_corr, np.clip(-resid, 0.0, None))
    comb = mis_logz(logl, beta, p.recorrected_logz(hot=hot_comb))

    f_mbar = mbar(logl, beta, logz)
    est_mbar = mis_logz(logl, beta, f_mbar)

    # tilted states: beta* = beta - resid / Var(logl), clipped to stay
    # >= beta (resid > 0 readings are extrapolation noise; a colder-
    # than-nominal tilt has no mechanism here) and <= 1
    var = np.maximum(np.var(logl, axis=1), 1e-12)
    tilt_amt = np.clip(-resid / var, 0.0, None)
    beta_t = np.clip(beta + tilt_amt, 0.0, 1.0)
    # rung f at tilted betas: interpolate stored ladder logz(beta)
    order = np.argsort(beta)
    f_tilt_init = np.interp(beta_t, beta[order], logz[order])
    tilt = mis_logz(logl, beta_t, f_tilt_init)
    f_mbar_t = mbar(logl, beta_t, f_tilt_init)
    est_mbar_t = mis_logz(logl, beta_t, f_mbar_t)

    rows = [("raw", raw), ("retro", retro), ("mbar", est_mbar),
            ("tilt", tilt), ("mbar*", est_mbar_t),
            ("corrlaw", corrlaw), ("comb", comb)]

    if oracle is not None:
        # (a) ORACLE RUNGS: exact logZ(beta_t) in the denominators. If
        # this is exact, the samples are fine and only the rung values
        # need repair; residual error here is population coverage.
        f_exact = oracle(beta)
        rows.append(("oracle", mis_logz(logl, beta, f_exact)))
        # (b) ORACLE TILT: leave the causal rungs, but describe each
        # stage population by its EXACT hotness-matched temperature
        # beta* s.t. E_{beta*}[logl] = mean(logl_t) (inverted from the
        # oracle mean-energy curve by monotone interpolation).
        bg = np.linspace(0.0, 1.0, 2001)
        eg = ladder_oracles.mean_logl(oracle, bg)
        mt = logl.mean(axis=1)
        beta_star = np.interp(mt, eg, bg)  # eg increasing in beta
        f_star = np.interp(beta_star, bg, oracle(bg))
        rows.append(("o-tilt", mis_logz(logl, beta_star, f_star)))
        # per-rung diagnostics: stored-rung error and exact hotness
        hot_exact = ladder_oracles.mean_logl(oracle, beta) - mt
        err_rung = logz - f_exact
        print(f"  T={T} n={n}  exact {expect:.3f}")
        print("  rung errors (logz_stored - exact): "
              f"first5 {np.round(err_rung[:5], 3)} "
              f"last5 {np.round(err_rung[-5:], 3)} "
              f"max|.| {np.abs(err_rung).max():.3f}")
        print("  exact hotness E_b[logl]-mean(logl): "
              f"first5 {np.round(hot_exact[:5], 2)} "
              f"last5 {np.round(hot_exact[-5:], 2)}")
        print("  beta tilt (beta* - beta): "
              f"median {np.median(beta_star - beta):+.4f} "
              f"max|.| {np.abs(beta_star - beta).max():.4f}")
    else:
        print(f"  T={T} n={n}  exact {expect:.3f}")
    for name, v in rows:
        print(f"  {name:7s} {v:.3f}  err {v - expect:+.3f}", flush=True)
    print(f"  tilt magnitudes: max {tilt_amt.max():.2e} "
          f"median {np.median(tilt_amt):.2e}  "
          f"dbeta median {np.median(np.diff(beta)):.2e}", flush=True)
    print(f"  hot_corr: sum dbeta*hot "
          f"{np.sum(np.diff(beta, append=beta[-1]) * hot_corr):.3f}  "
          f"max {hot_corr.max():.3f}", flush=True)


_orig_run = bc.run


_current = {"name": None}


def run_and_eval(name, prior, loglike, expect, seed=0, **kw):
    s = _orig_run(name, prior, loglike, expect, seed=seed, **kw)
    if expect is not None:
        cfg = _current["name"]
        evaluate(s, expect, oracle=ladder_oracles.ORACLES.get(cfg),
                 save_as=f"{cfg}_s{seed}" if cfg else None)
    return s


bc.run = run_and_eval

if __name__ == "__main__":
    names = [a for a in sys.argv[1:] if "=" not in a] or ["quickstart"]
    kw = {}
    for a in sys.argv[1:]:
        if "=" in a:
            k, v = a.split("=", 1)
            try:
                kw[k] = int(v)
            except ValueError:
                kw[k] = float(v)
    for nm in names:
        _current["name"] = nm
        bc.ALL[nm](**kw)
