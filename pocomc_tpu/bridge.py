"""Flow-anchored bridge evidence — the warped temperature path.

The persistent-sampling logZ ladder anneals prior -> posterior along
pi_beta ∝ prior * L^beta and reads evidence increments off its own
stage populations. Round-4 forensics (RESULTS.md "ladder mechanism
probes") decomposed its curved-geometry bias into per-rung walker
memory plus population coverage the beta-path never acquires (funnel
necks, Rosenbrock ridges). This module replaces that path for the
EVIDENCE estimate only: anneal a FRESH population from the trained
flow to the posterior along the geometric bridge in the flow's latent
space,

    pi_s(theta) ∝ N(theta; 0, I) * exp(s * f(theta)),   s: 0 -> 1
    f(theta) = log p(x(theta)) + log L(x(theta)) + log|J(theta)|
               - log N(theta; 0, I)

where x(theta) is the composed flow/scaler pullback and |J| its full
Jacobian. Normalization is invariant under the pullback, so
Z(s=1) = Z_posterior, while s=0 is EXACTLY sampleable (theta ~ N(0,I)
iid — a fresh flow draw with no resampling genealogy, hence no walker
memory). Evidence increments are conditional IS ratios
log E_{pi_s}[exp(ds * f)], with systematic resampling and latent
t-pCN mutations between rungs (theta' = sqrt(1-sig^2) theta + sig z is
N(0,I)-reversible, so the Metropolis ratio is exp(s * (f' - f))
exactly — no covariance fit needed in the whitened latent).

Behavior by flow quality: a perfect flow has constant f, the adaptive
schedule takes ONE rung and the estimator degenerates to plain
flow-IS; a flow that under-covers produces a heavy upper f-tail, the
ESS controller inserts rungs exactly across the mismatch, and the
mutations migrate particles into the under-covered regions — the
failure mode the raw ladder cannot repair after the fact.

Replaces: the beta-path evidence read-out of the reference
(/root/reference/pocomc/sampler.py:717-805 tempering loop +
particles.py:215-231 logZ accumulation) for run(n_evidence=0) users;
the reference has no analogous second path.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mcmc import f32_precision
from .ops.resampling import systematic_resample_jax


def make_bridge_programs(scaler, log_prior, log_like, n_dim, flow_inv,
                         n_steps: int = 10, accept_target: float = 0.234):
    """Build (init, rung) jitted device programs.

    log_prior / log_like are batched TRACEABLE callables (the sampler
    passes its own device-wrapped versions); flow_inv is the kernel
    contract (params, theta) -> (u, log|det du/dtheta|). Everything is
    traced under f32 matmul precision (CLAUDE.md bf16 hazard).
    """

    def _f_eval(theta, flow_params, scaler_params):
        """f(theta) per row; -inf on any non-finite pullback/prior, and
        the likelihood evaluated only on finite rows (masked). Returns
        (f, x_safe, n_evals)."""
        u, ldjf = flow_inv(flow_params, theta)
        x, ldj = scaler.inverse(u, params=scaler_params)
        if scaler.has_boundary:
            x = scaler.apply_boundary_conditions_x(x)
            u2 = scaler.forward(x, check_input=False, params=scaler_params)
            x, ldj = scaler.inverse(u2, params=scaler_params)
        finite = (jnp.isfinite(ldjf) & jnp.isfinite(ldj)
                  & jnp.all(jnp.isfinite(x), axis=1))
        x_safe = jnp.where(finite[:, None], x, 0.0)
        logp = jnp.where(finite, log_prior(x_safe), -jnp.inf)
        finite = finite & jnp.isfinite(logp)
        logl = log_like(x_safe, finite)
        log_n = (-0.5 * jnp.sum(theta**2, axis=-1)
                 - 0.5 * n_dim * math.log(2.0 * math.pi))
        f = jnp.where(finite & jnp.isfinite(logl),
                      logl + logp + ldj + ldjf - log_n, -jnp.inf)
        return f, jnp.sum(finite)

    def _init_impl(flow_params, scaler_params, seed, n):
        # f32 matmul precision must be active INSIDE the traced body
        # (CLAUDE.md bf16 hazard): flow + user likelihood/prior compute
        with jax.default_matmul_precision("float32"):
            k_draw, _ = jax.random.split(jax.random.key(seed))
            theta = jax.random.normal(k_draw, (n, n_dim),
                                      dtype=jnp.float32)
            f, n_ev = _f_eval(theta, flow_params, scaler_params)
            return theta, f, n_ev

    init = jax.jit(_init_impl, static_argnames=("n",))

    @jax.jit
    @f32_precision
    def rung(theta, f, sigma, s_new, ds, seed, flow_params, scaler_params):
        """One bridge rung: systematic resample by exp(ds * f), then
        n_steps of latent t-pCN at temperature s_new with diminishing
        sigma adaptation. Returns (theta, f, sigma, mean_accept, calls)."""
        n = theta.shape[0]
        key = jax.random.key(seed)
        k_res, key = jax.random.split(key)
        # weights exp(ds*f), max-normalized; all--inf guarded by caller
        lw = ds * f
        w = jnp.exp(lw - jnp.max(lw))
        idx = systematic_resample_jax(k_res, n, w)
        theta = theta[idx]
        f = f[idx]

        sig_loc = min(2.38 / math.sqrt(n_dim), 0.99)

        def step(carry, k):
            th, fv, sig, i = carry
            k_prop, k_unif = jax.random.split(k)
            z = jax.random.normal(k_prop, th.shape, dtype=th.dtype)
            th_p = jnp.sqrt(1.0 - sig**2) * th + sig * z
            f_p, n_ev = _f_eval(th_p, flow_params, scaler_params)
            # N(0,I)-reversible proposal: the Metropolis ratio for
            # N * exp(s f) is exp(s * (f' - f))
            alpha = jnp.minimum(1.0, jnp.exp(s_new * (f_p - fv)))
            alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
            acc = jax.random.uniform(k_unif, (th.shape[0],),
                                     dtype=alpha.dtype) < alpha
            th = jnp.where(acc[:, None], th_p, th)
            fv = jnp.where(acc, f_p, fv)
            a_mean = jnp.mean(alpha)
            i1 = (i + 1).astype(sig.dtype)
            # Misfit-adaptive sigma cap, same interpolation as the main
            # t-pCN kernel (mcmc.py _tpcn_cap): the bridge target's
            # mismatch to the N(0,I) proposal base is exactly s*f up to
            # a constant, so std(s*f) over the live population measures
            # whether near-independent proposals can be trusted. A
            # well-fit flow (std -> 0) frees sigma to 0.99; a misfit
            # one collapses it to the local 2.38/sqrt(d) scale so the
            # under-covered regions (funnel necks) mutate locally
            # instead of freezing under always-rejected global jumps.
            ok = jnp.isfinite(fv)
            nn = jnp.maximum(jnp.sum(ok), 1).astype(sig.dtype)
            fm = jnp.sum(jnp.where(ok, fv, 0.0)) / nn
            fvar = jnp.sum(jnp.where(ok, (fv - fm) ** 2, 0.0)) / nn
            misfit = s_new * jnp.sqrt(fvar)
            cap = sig_loc + (0.99 - sig_loc) * jnp.exp(-0.5 * misfit**2)
            sig = jnp.clip(sig + (a_mean - accept_target) / i1**0.75,
                           1e-3, cap)
            return (th, fv, sig, i + 1), (a_mean, n_ev)

        keys = jax.random.split(key, n_steps)
        (theta, f, sigma, _), (accs, n_evs) = jax.lax.scan(
            step, (theta, f, sigma, jnp.asarray(0, jnp.int32)), keys)
        return theta, f, sigma, jnp.mean(accs), jnp.sum(n_evs)

    return init, rung


def make_bridge_host_program(scaler, log_prior, n_dim, flow_inv):
    """Device half of the BLACK-BOX bridge: theta -> (x_safe, f_partial,
    finite) where f_partial = logp + ldj_scaler + ldj_flow - logN(theta)
    — everything except the host likelihood. One jitted call per host
    step; the likelihood runs in the user's Python between calls (same
    split as the sampler's stepped sweep driver)."""

    @jax.jit
    @f32_precision
    def to_x(flow_params, scaler_params, theta):
        u, ldjf = flow_inv(flow_params, theta)
        x, ldj = scaler.inverse(u, params=scaler_params)
        if scaler.has_boundary:
            x = scaler.apply_boundary_conditions_x(x)
            u2 = scaler.forward(x, check_input=False, params=scaler_params)
            x, ldj = scaler.inverse(u2, params=scaler_params)
        finite = (jnp.isfinite(ldjf) & jnp.isfinite(ldj)
                  & jnp.all(jnp.isfinite(x), axis=1))
        x_safe = jnp.where(finite[:, None], x, 0.0)
        logp = jnp.where(finite, log_prior(x_safe), -jnp.inf)
        finite = finite & jnp.isfinite(logp)
        log_n = (-0.5 * jnp.sum(theta**2, axis=-1)
                 - 0.5 * n_dim * math.log(2.0 * math.pi))
        f_part = jnp.where(finite, logp + ldj + ldjf - log_n, -jnp.inf)
        return x_safe, f_part, finite

    return to_x


def run_bridge_host(to_x, log_like_host, flow_params, scaler_params,
                    n: int, n_dim: int, rng: np.random.Generator,
                    fetch=jax.device_get, n_steps: int = 10,
                    ess_target: float = 0.5, max_rungs: int = 64,
                    sigma0: float = 0.9, accept_target: float = 0.234):
    """Host-orchestrated bridge for black-box likelihoods: mutation
    loop in numpy, flow/scaler pullbacks via `to_x` (one device call
    per step), likelihood via `log_like_host(x) -> logl`. Same
    estimator as run_bridge; same return contract."""

    def f_eval(theta):
        out = to_x(flow_params, scaler_params,
                   jnp.asarray(theta, jnp.float32))
        x = np.asarray(fetch(out[0]), dtype=np.float64)
        f_part = np.asarray(fetch(out[1]), dtype=np.float64)
        finite = np.asarray(fetch(out[2])).astype(bool)
        logl = np.full(n, -np.inf)
        if finite.any():
            logl[finite] = np.asarray(
                log_like_host(x[finite]), dtype=np.float64)
        f = np.where(finite & np.isfinite(logl), f_part + logl, -np.inf)
        return f, int(finite.sum())

    sig_loc = min(2.38 / math.sqrt(n_dim), 0.99)
    theta = rng.standard_normal((n, n_dim))
    f, calls = f_eval(theta)
    if not np.isfinite(f).any():
        return None

    sigma = sigma0
    s, logz, var = 0.0, 0.0, 0.0
    s_path, ess_min, acc = [], 1.0, float("nan")
    for _ in range(max_rungs):
        if not np.isfinite(f).any():
            return None  # mid-ladder degeneracy: fall back to the ladder
        hi = 1.0 - s
        if _ess_frac(hi * f) >= ess_target:
            ds = hi
        else:
            lo = 0.0
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if _ess_frac(mid * f) >= ess_target:
                    lo = mid
                else:
                    hi = mid
            ds = max(lo, 1e-6 * (1.0 - s))
        ess_min = min(ess_min, _ess_frac(ds * f))
        logz += _logmeanexp(ds * f)
        var += _boot_var(ds * f, rng)
        s = min(s + ds, 1.0)
        s_path.append(s)
        if s >= 1.0:
            break
        # systematic resample by exp(ds*f)
        lw = ds * f
        w = np.exp(lw - np.max(lw[np.isfinite(lw)]))
        w = np.where(np.isfinite(w), w, 0.0)
        w = w / w.sum()
        pos = (rng.random() + np.arange(n)) / n
        idx = np.searchsorted(np.cumsum(w), pos, side="right")
        idx = np.clip(idx, 0, n - 1)
        theta, f = theta[idx], f[idx]
        # K latent t-pCN steps at temperature s (numpy mirror of the
        # device rung, incl. the misfit-adaptive sigma cap)
        for i in range(n_steps):
            z = rng.standard_normal((n, n_dim))
            th_p = math.sqrt(1.0 - sigma**2) * theta + sigma * z
            f_p, n_ev = f_eval(th_p)
            calls += n_ev
            with np.errstate(over="ignore", invalid="ignore"):
                alpha = np.minimum(1.0, np.exp(s * (f_p - f)))
            alpha = np.where(np.isnan(alpha), 0.0, alpha)
            accept = rng.random(n) < alpha
            theta = np.where(accept[:, None], th_p, theta)
            f = np.where(accept, f_p, f)
            a_mean = float(alpha.mean())
            ok = np.isfinite(f)
            misfit = s * float(np.std(f[ok])) if ok.any() else 0.0
            cap = sig_loc + (0.99 - sig_loc) * math.exp(
                -0.5 * misfit**2)
            sigma = float(np.clip(
                sigma + (a_mean - accept_target) / (i + 1) ** 0.75,
                1e-3, cap))
            acc = a_mean
    else:
        return None
    return dict(logz=float(logz), logz_err=float(np.sqrt(var)),
                rungs=len(s_path), calls=calls,
                ess_min=float(ess_min), accept_last=acc,
                s_path=np.asarray(s_path))


def _ess_frac(lw: np.ndarray) -> float:
    """ESS/n of weights exp(lw) over ALL n rows (-inf rows count in n)."""
    ok = np.isfinite(lw)
    if not ok.any():
        return 0.0
    m = lw[ok].max()
    w = np.exp(lw[ok] - m)
    return float(w.sum() ** 2 / (len(lw) * (w * w).sum()))


def _logmeanexp(lw: np.ndarray) -> float:
    ok = np.isfinite(lw)
    if not ok.any():
        return -np.inf
    m = lw[ok].max()
    return float(m + np.log(np.exp(lw[ok] - m).sum()) - np.log(len(lw)))


def _boot_var(lw: np.ndarray, rng: np.random.Generator,
              n_boot: int = 200) -> float:
    """Bootstrap variance of _logmeanexp over particles (host f64)."""
    n = len(lw)
    w = np.exp(np.where(np.isfinite(lw), lw - np.nanmax(
        np.where(np.isfinite(lw), lw, -np.inf)), -np.inf))
    w = np.where(np.isfinite(w), w, 0.0)
    idx = rng.integers(0, n, size=(n_boot, n))
    means = w[idx].mean(axis=1)
    vals = np.log(np.maximum(means, 1e-300))
    return float(np.var(vals))


def run_bridge(init, rung, flow_params, scaler_params, n: int,
               seed_fn, fetch=jax.device_get, ess_target: float = 0.5,
               max_rungs: int = 64, sigma0: float = 0.9):
    """Host orchestration of the bridge ladder (f64 bookkeeping).

    Picks each ds by bisection so the incremental-weight ESS fraction
    stays at ess_target (capped at reaching s=1), accumulates
    logZ += log mean exp(ds * f), and runs the mutation rung program.
    Two transfers per rung (f down, rung up) — ~10 rungs on a good
    flow, so transfer latency stays negligible next to the sweeps.

    Returns dict(logz, logz_err, rungs, calls, ess_min, accept_last,
    s_path) or None when the population is degenerate (no finite f at
    s=0). logz_err is the per-particle bootstrap error accumulated over
    rungs (rungs treated independent — conservative given the mutation
    steps between them).
    """
    theta, f, n_ev = init(flow_params, scaler_params, seed_fn(), n=n)
    calls = int(fetch(n_ev))
    f_host = np.asarray(fetch(f), dtype=np.float64)
    if not np.isfinite(f_host).any():
        return None

    boot_rng = np.random.default_rng(int(seed_fn()))
    sigma = jnp.asarray(sigma0, jnp.float32)
    s, logz, var = 0.0, 0.0, 0.0
    s_path, ess_min, acc = [], 1.0, float("nan")
    for _ in range(max_rungs):
        if not np.isfinite(f_host).any():
            return None  # mid-ladder degeneracy: fall back to the ladder
        # bisection on ds: ESS fraction of exp(ds*f) decreases in ds
        hi = 1.0 - s
        if _ess_frac(hi * f_host) >= ess_target:
            ds = hi
        else:
            lo = 0.0
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if _ess_frac(mid * f_host) >= ess_target:
                    lo = mid
                else:
                    hi = mid
            ds = max(lo, 1e-6 * (1.0 - s))
        ess_min = min(ess_min, _ess_frac(ds * f_host))
        logz += _logmeanexp(ds * f_host)
        var += _boot_var(ds * f_host, boot_rng)
        s = min(s + ds, 1.0)
        s_path.append(s)
        if s >= 1.0:
            break  # final increment accumulated; no mutation needed
        theta, f, sigma, a_mean, n_ev = rung(
            theta, f, sigma, jnp.asarray(s, jnp.float32),
            jnp.asarray(ds, jnp.float32), seed_fn(), flow_params,
            scaler_params)
        f_host = np.asarray(fetch(f), dtype=np.float64)
        calls += int(fetch(n_ev))
        acc = float(fetch(a_mean))
    else:
        return None  # never reached s=1 within max_rungs
    return dict(logz=float(logz), logz_err=float(np.sqrt(var)),
                rungs=len(s_path), calls=calls,
                ess_min=float(ess_min), accept_last=acc,
                s_path=np.asarray(s_path))
