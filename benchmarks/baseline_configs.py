"""North-star benchmark configs (BASELINE.md / RESULTS.md tables).

Run on the GPU from the repo root:

    python benchmarks/baseline_configs.py [config ...]

Configs: rosenbrock10, gauss50, mixture20, funnel25, cosmo30.
Analytic truths are computed in-script (quadrature / closed form);
the chained-Rosenbrock truth -50.033 comes from an 8001-point
transfer-matrix quadrature (stable under grid refinement).
"""
import sys, time
import numpy as np
import jax, jax.numpy as jnp
from scipy.stats import multivariate_normal, norm
import pocomc_tpu as pc


# one row per completed run, for the multi-seed summary (seeds=... mode):
# dict(name, seed, wall, calls, logz_err, smc_err, smcraw_err, khat)
ROWS = []


def run(name, prior, loglike, expect, seed=0, **kw):
    t0 = time.time()
    s = pc.Sampler(prior, loglike, vectorize=True, random_state=seed, **kw)
    s.run(n_total=4096, n_evidence=4096, progress=False)
    wall = time.time() - t0
    it = int(s.t) if hasattr(s, "t") else -1
    # SMC persistent-sampling ladder: raw causal + retroactive per-rung
    # re-correction, for comparison. bridgeZ is the flow-anchored bridge
    # (pocomc_tpu/bridge.py) — what run(n_evidence=0) RETURNS since
    # round 5 (the ladder columns stay for forensic continuity).
    smc_logz = float(s.particles.compute_logw_and_logz(
        1.0, recorrect=True)[1])
    smc_raw = float(s.particles.compute_logw_and_logz(1.0)[1])
    br = s._compute_bridge_evidence()
    br_logz = None if br is None else br["logz"]
    exp_s = "n/a" if expect is None else f"{expect:.3f}"
    err = "" if expect is None else f"  err {s.logz - expect:+.3f}"
    smc_err = "" if expect is None else f" (err {smc_logz - expect:+.3f})"
    smc_rerr = "" if expect is None else f" (err {smc_raw - expect:+.3f})"
    if br_logz is None:
        br_s = "  bridgeZ n/a"
    else:
        br_e = ("" if expect is None
                else f" (err {br_logz - expect:+.3f},"
                     f" {br['rungs']}r/{br['calls']}c)")
        br_s = f"  bridgeZ {br_logz:.3f}{br_e}"
    print(f"{name}: wall {wall:.0f}s  iters {it}  calls {s.calls}  "
          f"logZ {s.logz:.3f} +- {s.logz_err:.3f}  khat {s.evidence_khat:.2f}"
          f"  smcZ {smc_logz:.3f}{smc_err}  smcZraw {smc_raw:.3f}{smc_rerr}"
          f"{br_s}  analytic {exp_s}{err}",
          flush=True)
    import os
    if os.environ.get("POCOMC_ITER_TABLE"):
        print("  t    beta  steps sigma   acc  corr   hot z_logl z_dim "
              "resid      nu misfit   ep   loss")
        for d_ in s._dev_iter_stats:
            c = d_.get("corr")
            tl = d_.get("train_loss")
            te = d_.get("train_epochs")
            print(f"  {d_['iter']:3d} {d_['beta']:.4f} {d_['steps']:4d} "
                  f"{d_.get('sigma', 0.0):5.2f} {d_['accept']:5.2f} "
                  f"{c if c is None else round(c, 3)} "
                  f"{d_.get('hot', 0.0):5.1f} {d_.get('z_logl', 0.0):6.1f} "
                  f"{d_.get('z_dim', 0.0):5.1f} "
                  f"{d_.get('resid', 0.0):8.2f} "
                  f"{d_.get('nu', 0.0):7.0f} "
                  f"{d_.get('misfit', 0.0):6.2f} "
                  f"{'-' if te is None else te:>4} "
                  f"{'-' if tl is None else round(tl, 1):>7}", flush=True)
    ROWS.append(dict(
        name=name.split()[0], seed=seed, wall=wall, calls=int(s.calls),
        khat=float(s.evidence_khat),
        logz_err=None if expect is None else float(s.logz - expect),
        smc_err=None if expect is None else float(smc_logz - expect),
        smcraw_err=None if expect is None else float(smc_raw - expect),
        bridge_err=(None if (expect is None or br_logz is None)
                    else float(br_logz - expect))))
    return s


def rosenbrock10(**kw):
    # chained variant, coeff 100; truth -50.033 by transfer-matrix
    # quadrature (8001-pt grid, validated stable vs grid refinement)
    d = 10
    prior = pc.Prior([pc.Uniform(-10, 10) for _ in range(d)])
    def loglike(x):
        return -jnp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                        + (1.0 - x[..., :-1]) ** 2, axis=-1)
    run("rosenbrock10-chained (1024 active)", prior, loglike, -50.033,
        n_effective=2048, n_active=1024, **kw)


def _posterior_moment_check(s, cov, ps):
    """Weighted posterior mean/cov against the analytic Gaussian
    posterior (precision = C^-1 + I/ps^2). Reports worst-coordinate
    z-score-style errors normalized by the posterior scale."""
    prec = np.linalg.inv(cov) + np.eye(cov.shape[0]) / ps**2
    post_cov = np.linalg.inv(prec)
    sd = np.sqrt(np.diag(post_cov))
    x, w, _, _ = s.posterior()
    w = w / w.sum()
    mean = w @ x
    xc = x - mean
    emp_cov = (xc * w[:, None]).T @ xc
    mean_err = np.max(np.abs(mean) / sd)
    var_err = np.max(np.abs(np.diag(emp_cov) / np.diag(post_cov) - 1.0))
    corr = post_cov / np.outer(sd, sd)
    emp_sd = np.sqrt(np.diag(emp_cov))
    emp_corr = emp_cov / np.outer(emp_sd, emp_sd)
    corr_err = np.max(np.abs(emp_corr - corr))
    print(f"  posterior moments: max |mean|/sd {mean_err:.3f}  "
          f"max |var ratio - 1| {var_err:.3f}  "
          f"max |corr err| {corr_err:.3f}", flush=True)


def gauss50_problem(d=50):
    """The gauss50 problem: a rotated Gaussian likelihood with condition
    number 1e3 under a N(0, 100) prior. Returns (prior, loglike, exact
    logZ, Sampler kwargs, covariance, prior scale)."""
    rng = np.random.default_rng(0)
    evals = np.logspace(0, 3, d)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (Q * evals) @ Q.T
    cov_inv_j = jnp.asarray(np.linalg.inv(cov), dtype=jnp.float32)
    norm_const = -0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1])
    def loglike(x):
        return norm_const - 0.5 * jnp.einsum("ni,ij,nj->n", x, cov_inv_j, x)
    ps = 100.0
    prior = pc.Prior([pc.Normal(0, ps) for _ in range(d)])
    expect = multivariate_normal.logpdf(np.zeros(d), np.zeros(d),
                                        cov + ps**2 * np.eye(d))
    return (prior, loglike, expect,
            dict(n_effective=4096, n_active=2048), cov, ps)


def gauss50(**kw):
    prior, loglike, expect, sizes, cov, ps = gauss50_problem()
    s = run("gauss50 cond1e3 N(0,100)", prior, loglike, expect,
            **sizes, **kw)
    _posterior_moment_check(s, cov, ps)


def mixture20(**kw):
    d, sep, sig = 20, 2.0, 1.0
    w1, w2 = 0.7, 0.3
    m = np.full(d, sep)
    def loglike(x):
        l1 = -0.5 * jnp.sum((x - m) ** 2, axis=-1) / sig**2 \
             - d * jnp.log(np.sqrt(2 * np.pi) * sig)
        l2 = -0.5 * jnp.sum((x + m) ** 2, axis=-1) / sig**2 \
             - d * jnp.log(np.sqrt(2 * np.pi) * sig)
        return jnp.logaddexp(jnp.log(w1) + l1, jnp.log(w2) + l2)
    ps = 10.0
    prior = pc.Prior([pc.Normal(0, ps) for _ in range(d)])
    var = sig**2 + ps**2
    logcomp = -0.5 * np.sum(m**2) / var - (d / 2) * np.log(2 * np.pi * var)
    expect = logcomp  # w1+w2 = 1, symmetric modes
    s = run("mixture20 70/30", prior, loglike, expect,
            n_effective=2048, n_active=1024, **kw)
    x, w, _, _ = s.posterior()
    mass1 = float(w[x[:, 0] > 0].sum() / w.sum())
    print(f"  mode mass recovered {mass1:.3f} (true 0.700)", flush=True)


def funnel25(**kw):
    d, sv, half = 25, 3.0, 40.0
    def loglike(x):
        v = x[..., 0]
        y = x[..., 1:]
        var = jnp.exp(v)
        return (-0.5 * jnp.sum(y**2, axis=-1) / var
                - ((d - 1) / 2) * (v + jnp.log(2 * jnp.pi)))
    prior = pc.Prior([pc.Normal(0, sv)]
                     + [pc.Uniform(-half, half) for _ in range(d - 1)])
    # exact truth includes the N(0, e^v) mass outside the Uniform box at
    # large v (1-D quadrature; -0.028 nats at these widths)
    from scipy import integrate
    def _f(v):
        p = norm.cdf(half, scale=np.exp(v / 2)) \
            - norm.cdf(-half, scale=np.exp(v / 2))
        return norm.pdf(v, scale=sv) * p ** (d - 1)
    expect = (d - 1) * np.log(1.0 / (2 * half)) \
        + np.log(integrate.quad(_f, -60, 60, limit=400)[0])
    run("funnel25", prior, loglike, expect,
        n_effective=2048, n_active=1024, **kw)


def cosmo30(**kw):
    d = 30
    rng = np.random.default_rng(0)
    evals = np.logspace(0, 2, d)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    cov = (Q * evals) @ Q.T
    cov_inv_j = jnp.asarray(np.linalg.inv(cov), dtype=jnp.float32)
    norm_const = -0.5 * (d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1])
    def loglike(x):
        return norm_const - 0.5 * jnp.einsum("ni,ij,nj->n", x, cov_inv_j, x)
    ps = 20.0
    prior = pc.Prior([pc.Normal(0, ps) for _ in range(d)])
    expect = multivariate_normal.logpdf(np.zeros(d), np.zeros(d),
                                        cov + ps**2 * np.eye(d))
    s = run("cosmo30 8192/2048", prior, loglike, expect,
            n_effective=8192, n_active=2048, **kw)
    _posterior_moment_check(s, cov, ps)


def quickstart(**kw):
    # the reference quickstart (BASELINE.md row 1): banana-coupled 10-D
    # Rosenbrock, N(0,3) prior, pure Sampler defaults. Exact logZ by 1-D
    # quadrature of the pairwise-factorized integrand: -21.4021.
    d = 10
    prior = pc.Prior([pc.Normal(0.0, 3.0) for _ in range(d)])
    def loglike(x):
        return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                        + (x[..., ::2] - 1.0) ** 2, axis=-1)
    run("quickstart (ref defaults)", prior, loglike, -21.4021, **kw)


ALL = dict(rosenbrock10=rosenbrock10, gauss50=gauss50, mixture20=mixture20,
           funnel25=funnel25, cosmo30=cosmo30, quickstart=quickstart)

if __name__ == "__main__":
    # extra `key=value` args become Sampler kwargs (e.g. corr_threshold=0)
    names, kw = [], {}
    for a in sys.argv[1:]:
        if "=" in a:
            k, v = a.split("=", 1)
            if v in ("True", "true", "False", "false"):
                kw[k] = v in ("True", "true")
            else:
                try:
                    kw[k] = int(v)
                except ValueError:
                    try:
                        kw[k] = float(v)
                    except ValueError:
                        kw[k] = v
        else:
            names.append(a)
    # multi-seed mode (VERDICT r4 #4): `seeds=0,1,2,3` runs every config
    # at each seed and prints a median/IQR summary for the logZ errors
    # AND the call counts — trajectory-chaotic quantities (the whole beta
    # ladder re-randomizes per seed) must not be judged at one seed.
    seeds = kw.pop("seeds", None)
    if seeds is not None:
        seed_list = [int(x) for x in str(seeds).split(",")]
        for n in (names or list(ALL)):
            for sd in seed_list:
                ALL[n](seed=sd, **kw)
        print("\n=== multi-seed summary (median [IQR] over seeds "
              f"{seed_list}) ===")
        print(f"{'config':14s} {'logz_err':>22s} {'smcZ_err':>22s} "
              f"{'smcZraw_err':>22s} {'bridge_err':>22s} "
              f"{'calls':>26s} {'wall_s':>14s}")
        byname = {}
        for r in ROWS:
            byname.setdefault(r["name"], []).append(r)
        def _mi(vals, fmt):
            v = np.asarray([x for x in vals if x is not None], float)
            if len(v) == 0:
                return "n/a"
            q1, q2, q3 = np.percentile(v, [25, 50, 75])
            return f"{q2:{fmt}} [{q1:{fmt}},{q3:{fmt}}]"
        for n, rows in byname.items():
            print(f"{n:14s} {_mi([r['logz_err'] for r in rows], '+.3f'):>22s}"
                  f" {_mi([r['smc_err'] for r in rows], '+.3f'):>22s}"
                  f" {_mi([r['smcraw_err'] for r in rows], '+.3f'):>22s}"
                  f" {_mi([r['bridge_err'] for r in rows], '+.3f'):>22s}"
                  f" {_mi([r['calls'] for r in rows], '.0f'):>26s}"
                  f" {_mi([r['wall'] for r in rows], '.1f'):>14s}",
                  flush=True)
    else:
        for n in (names or list(ALL)):
            ALL[n](**kw)
