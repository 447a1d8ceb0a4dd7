"""MCMC mutation kernels: t-preconditioned Crank-Nicolson and random-walk
Metropolis, with and without normalizing-flow preconditioning.

JAX re-design of reference pocomc/mcmc.py:7-654.
The reference runs a host `while True` loop with per-walker Python `for k`
loops for the InvGamma scale draws, proposals and Student-t quadratic forms
(mcmc.py:79-85, 127-129) — O(n_active * d^2) host work per step. Here the
entire adaptive sweep is ONE jitted program:

  - proposals, quadratic forms and Metropolis corrections are batched
    einsums/matmuls over the whole (n_active, d) population,
  - the adaptive-length loop (plateau termination + diminishing adaptation,
    reference mcmc.py:152-180) is a `lax.while_loop` whose carry holds
    (state, sigma, mu, counters, RNG key),
  - the user likelihood is either traced straight into the program (JAX
    likelihoods) or enters via `jax.pure_callback` with the finite-proposal
    mask applied host-side so call-counting semantics match the reference
    (mcmc.py:113-121),
  - boundary re-wrapping (mcmc.py:94-97) is closed-form (see scaler.py).

Each sweep returns the same result dictionary as the reference kernels
(mcmc.py:182-183): u, x, logdetj, logl, logp, efficiency, accept, steps,
calls, proposal_scale.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class SweepState(NamedTuple):
    u: jnp.ndarray
    x: jnp.ndarray
    logdetj: jnp.ndarray
    logl: jnp.ndarray
    logp: jnp.ndarray
    theta: jnp.ndarray          # flow-latent state (zeros when not preconditioned)
    logdetj_flow: jnp.ndarray   # log|det du/dtheta| at current state
    sigma: jnp.ndarray
    mu: jnp.ndarray
    grad: jnp.ndarray           # v-space target gradient (MALA; else zeros)
    i: jnp.ndarray              # step counter
    cnt: jnp.ndarray            # plateau counter
    logp2: jnp.ndarray          # best plateau metric so far
    calls: jnp.ndarray          # likelihood call counter
    accept: jnp.ndarray         # mean acceptance of last step
    v0: jnp.ndarray             # sweep-start u positions (decorrelation probe)
    corr: jnp.ndarray           # max |per-dim corr(v0, u_now)| across dims
    u_snap: jnp.ndarray         # u at the last drift-window refresh
    logl_snap: jnp.ndarray      # logl at the last drift-window refresh
    i_snap: jnp.ndarray         # step index of that refresh
    hot: jnp.ndarray            # 1.0 while the last closed window showed
                                # statistically significant population
                                # drift (see calib_z in accept_update)
    resid: jnp.ndarray          # residual-hotness estimate: geometric
                                # extrapolation of the remaining mean-logl
                                # relaxation at sweep end (ladder bias
                                # correction; see accept_update)
    z_logl: jnp.ndarray         # drift-test z of the last closed window:
    z_dim: jnp.ndarray          # paired mean-logl / max per-dim moment
                                # (diagnostics; surfaced in iter stats)
    misfit: jnp.ndarray         # std over the live population of
                                # log pi_v - log t_geom (nats): the
                                # geometry-fit statistic driving the
                                # adaptive sigma cap (tpcn only; 0 else)
    fresh: jnp.ndarray          # per-walker flag: 1.0 once the walker
                                # accepted an independence refresh
                                # (imh_every) since the last drift-window
                                # snapshot. A refreshed walker's paired
                                # displacement is a fresh flow draw, not
                                # local relaxation — it would inflate the
                                # paired variances and BLIND the drift
                                # test (measured: funnel25 ladder
                                # -1.65 -> -2.29 with refresh unmasked,
                                # rungs 34 -> 22; RESULTS.md round 4
                                # "independence refresh"), so the window
                                # statistics exclude it. Reset at each
                                # window close.
    dbeta: jnp.ndarray          # current rung size beta_t - beta_{t-1}
                                # (constant through the sweep): yardstick
                                # for the bias-budget stopping rule (see
                                # `cond`); 0 disables
    key: jnp.ndarray


# Drift-test window length (steps): paired per-walker displacements are
# accumulated over CALIB_W steps before each significance evaluation.
# Long enough that real relaxation outruns per-step noise, short enough
# that easy targets exiting on the ~5-step plateau rule never pay for a
# second window.
CALIB_W = 6

# Minimum never-refreshed rows for the drift test to be a statistic at
# all (imh_every > 0 masks refreshed walkers out of the paired-drift
# windows; see the `enough` guard in accept_update).
MIN_CALIB_N = 16


# --- live per-step sweep statistics tap ---------------------------------
# The reference prints calls/acc/steps DURING a sweep (mcmc.py:159-167);
# the fused lax.while_loop sweep is otherwise a black box until it
# returns. The sweep body can emit
# its packed stats each step through jax.debug.callback into a
# process-global sink (one sweep runs at a time per process). The sink is
# looked up at call time, so the emitting program stays shareable: with
# no sink registered the tap is a no-op.
_LIVE_SINK = None


def set_live_sink(fn):
    """Register ``fn(step, plateau_cnt, sigma, accept, calls)`` to receive
    per-step statistics from live-stats sweeps; ``None`` unregisters."""
    global _LIVE_SINK
    _LIVE_SINK = fn


def _live_emit(i, cnt, sigma, accept, calls):
    if _LIVE_SINK is not None:
        _LIVE_SINK(int(i), int(cnt), float(sigma), float(accept), int(calls))


def make_loglike_device(fn, vectorize: bool, traceable: bool, dtype=jnp.float32):
    """Wrap a user log-likelihood into `loglike(x, mask) -> logl` usable
    inside jit. Non-finite-mask rows receive -inf without being evaluated
    (callback path) or with sanitized inputs (traced path).

    The traced path runs under matmul precision 'float32': a default
    precision that rounds matmul/einsum INPUTS (bf16 keeps ~3 decimal
    digits, and GPUs may use TF32) makes a user likelihood built on
    einsums (e.g. a Gaussian quadratic form) return logl with
    O(|logl| * 4e-3) noise. That noise inflates every logsumexp-based
    weight reduction by ~sigma^2/2 nats and compounds through the
    persistent-sampling logz ladder (measured with bf16 inputs: +2.1
    nats SMC-evidence error on the 50-D cond-1e3 Gaussian, gone at f32
    precision; RESULTS.md round 3). Likelihood matmuls are a tiny
    fraction of sweep compute."""
    if traceable:
        fn32 = f32_precision(fn)

        def loglike(x, mask):
            return jnp.where(mask, fn32(x).astype(dtype), -jnp.inf)
        return loglike

    def host_eval(x, mask):
        x = np.asarray(x)
        mask = np.asarray(mask)
        out = np.full(x.shape[0], -np.inf, dtype=np.float64)
        idx = np.nonzero(mask)[0]
        if len(idx) > 0:
            if vectorize:
                out[idx] = np.asarray(fn(x[idx]), dtype=np.float64).reshape(-1)
            else:
                out[idx] = np.array([float(np.asarray(fn(xi)).reshape(())) for xi in x[idx]])
        return out.astype(np.float32 if dtype == jnp.float32 else np.float64)

    def loglike(x, mask):
        res_shape = jax.ShapeDtypeStruct((x.shape[0],), dtype)
        return jax.pure_callback(host_eval, res_shape, x, mask)

    return loglike


def f32_precision(fn):
    """Wrap a traced callable so its body runs under matmul precision
    'float32' — the one-line enforcement point for the reduced-precision
    hazard documented in make_loglike_device. Use this for EVERY path
    that traces user likelihood/prior code into a program."""
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped


def _student_quadform(diff, inv_cov):
    """Batched Mahalanobis quadratic form diag(diff @ inv_cov @ diff.T)."""
    return jnp.einsum("nd,de,ne->n", diff, inv_cov, diff)


def make_sweep(
    scaler,
    log_prior: Callable,
    log_like: Callable,          # loglike(x, mask) from make_loglike_device
    n_dim: int,
    n_steps: int,
    n_max: int,
    kind: str = "tpcn",          # "tpcn" | "rwm" | "mala" | "hmc"
    preconditioned: bool = False,
    flow_fwd: Callable | None = None,   # (params, u) -> (theta, log|det du/dtheta|)
    flow_inv: Callable | None = None,   # (params, theta) -> (u, log|det du/dtheta|)
    plateau_z: float = 0.0,
    corr_threshold: float = 0.0,        # decorrelation target; 0 disables
    calib_z: float = 0.0,               # equilibrium-calibration z-gate;
                                        # 0 disables (see accept_update)
    bias_budget: float = 0.0,           # per-rung evidence-bias budget
                                        # (nats): keep sweeping while
                                        # |resid| * dbeta exceeds it;
                                        # 0 disables (see `cond`)
    bias_rate: float = 0.0,             # run-total ladder-bias rate budget
                                        # (nats per unit beta): keep
                                        # sweeping while the dose-response
                                        # law's predicted rung bias
                                        # corr * dbeta * Var(logl) exceeds
                                        # it; 0 disables (see `cond`)
    bias_floor: float = 0.0,            # decorrelation floor for the
                                        # bias_rate rule: the rule never
                                        # demands corr below this (the
                                        # unrelaxed blanket target), so
                                        # per-rung spending is bounded by
                                        # what the d-scaled blanket would
                                        # have spent; 0 = no floor
    plateau_floor: float = 4.0,         # minimum plateau window (steps of
                                        # consecutive non-improvement
                                        # before the plateau rule can
                                        # stop a sweep); see `cond`
    live_stats: bool = False,           # per-step tap via jax.debug.callback
    n_leapfrog: int = 5,                # hmc only: leapfrog steps/proposal
    imh_every: int = 0,                 # tpcn+preconditioned only: every
                                        # imh_every-th sweep step proposes
                                        # an INDEPENDENT flow-base draw
                                        # (theta' ~ N(0,I)) instead of the
                                        # local t-pCN move. An accepted
                                        # independence move erases walker
                                        # memory outright, so decorrelation
                                        # costs O(1/acceptance) steps
                                        # instead of O(1/(alpha*sigma^2))
                                        # local steps; 0 disables
):
    """Build a jitted adaptive MCMC sweep over the whole active population.

    Returns sweep(u, x, logdetj, logl, logp, beta, sigma0, geom, key,
    flow_params=None) -> results dict. `geom` is the dict produced by
    models.geometry.fit_geometry_jax.
    """
    if kind not in ("tpcn", "rwm", "mala", "hmc", "imh"):
        raise ValueError(f"Invalid kernel kind {kind!r}")
    if preconditioned and (flow_fwd is None or flow_inv is None):
        raise ValueError("preconditioned sweep needs flow_fwd/flow_inv")
    if kind == "imh" and not preconditioned:
        raise ValueError(
            "kind='imh' proposes from the flow's latent base and "
            "requires preconditioning (precondition=True).")
    # the independence-refresh cadence needs the flow latent; plain-space
    # sweeps (warmup, precondition=False) silently run pure local moves
    if kind != "tpcn" or not preconditioned:
        imh_every = 0

    sqrt_d_scale = 2.38 / math.sqrt(n_dim)
    # t-pCN proposal scale cap, adapted per step from a measured
    # geometry-fit statistic (see `_tpcn_cap` in accept_update). The
    # reference caps at 2.38/sqrt(d) always (reference mcmc.py:152) — an
    # RWM optimal-scaling heuristic that defeats pCN's point: at
    # sigma -> 1 the autoregressive proposal sqrt(1-s^2)*(v-mu) + s*step
    # becomes an INDEPENDENT draw from the fitted t-geometry, so a
    # well-preconditioned population decorrelates in O(1) accepted steps
    # instead of O(1/sigma^2). Measured (RESULTS.md round 3
    # "stage-population hotness"): with the 2.38/sqrt(50)=0.336 cap the
    # gauss50 latent per-step correlation floor is sqrt(1-sigma^2)=0.94,
    # stage populations stay +2..+7.5 SE hot after full sweeps, and the
    # SMC logz ladder inherits +2.4 nats. But freeing the cap
    # UNCONDITIONALLY is wrong in the other direction (measured: funnel25
    # logZ err -2.2 -> -2.6): when the fitted geometry misses a region
    # (the funnel neck), near-independent proposals never land there, the
    # particles already in it freeze (global jumps out are rejected), and
    # population-mean acceptance — dominated by the well-fitted bulk —
    # never self-limits sigma. Only small-sigma LOCAL moves mutate
    # regions the fit misses, which is what the reference's cap
    # accidentally guarantees. Hence the per-step interpolation between
    # the two caps, driven by std(log pi_v - log t_geom) over the live
    # population — a direct measure of whether independence-style
    # proposals are trustworthy.
    sigma_cap = 0.99

    def _batch_corr(v0, v):
        """MAX |per-dim Pearson correlation| between the sweep-start and
        current positions: the particle-diversity probe behind the
        adaptive mutation budget (see `cond`). After resampling the
        population is duplicate-heavy; the sweep's job is to restore
        diversity, and this statistic measures directly how much memory
        of the start positions remains. Two measured-on-the-funnel design
        points (RESULTS.md round 3): the aggregation is max, not mean —
        a funnel has ONE pathological dimension out of d, and a mean
        dilutes it 1:(d-1) so the criterion never fires; and the probe
        runs in u space, not the flow latent space — a misfit flow
        (exactly the failure mode this budget exists to rescue) makes
        theta-space decorrelation look finished while the physical
        coordinates still remember their start. Pearson normalizes per
        dimension, so no whitening is needed; one cheap reduction per
        step."""
        v0c = v0 - jnp.mean(v0, axis=0)
        vc = v - jnp.mean(v, axis=0)
        num = jnp.mean(v0c * vc, axis=0)
        den = jnp.sqrt(jnp.mean(v0c * v0c, axis=0)
                       * jnp.mean(vc * vc, axis=0))
        return jnp.max(jnp.abs(num) / jnp.maximum(den, 1e-12))
    # Gradient kernels (beyond-reference, JAX-native: autodiff through
    # the composed flow/scaler/likelihood program); acceptance optima
    # 0.574 (MALA, Roberts & Rosenthal 1998) / 0.651 (HMC, Beskos et al.
    # 2013) vs 0.234 for the random-walk kernels. Both require a
    # traceable likelihood (the sampler gates this).
    accept_target = {"mala": 0.574, "hmc": 0.651}.get(kind, 0.234)

    def _to_x(v_prime, flow_params, scaler_params):
        """Map proposal in sampling space back to (u', x', logdetj',
        theta', logdetj_flow'), applying boundary conditions."""
        if preconditioned:
            theta_prime = v_prime
            u_prime, ldjf_prime = flow_inv(flow_params, theta_prime)
        else:
            theta_prime = jnp.zeros_like(v_prime)
            u_prime = v_prime
            ldjf_prime = jnp.zeros(v_prime.shape[0], v_prime.dtype)
        x_prime, ldj_prime = scaler.inverse(u_prime, params=scaler_params)
        if scaler.has_boundary:
            x_prime = scaler.apply_boundary_conditions_x(x_prime)
            u_prime = scaler.forward(x_prime, check_input=False,
                                     params=scaler_params)
            x_prime, ldj_prime = scaler.inverse(u_prime,
                                                params=scaler_params)
        return u_prime, x_prime, ldj_prime, theta_prime, ldjf_prime

    def _target_sum(v, beta, fallback_x, flow_params, scaler_params):
        """Scalar total v-space log-target with per-row components as aux,
        for ONE joint value-and-gradient pass (jax.vjp has_aux) — the MALA
        step gets the Metropolis components and the gradient from a single
        likelihood evaluation. Out-of-support rows get -inf values but
        contribute zero (never NaN) to the gradient: every sub-evaluation
        runs on sanitized inputs and masked rows are excluded from the
        sum (their cotangent is zero)."""
        u_p, x_p, ldj_p, theta_p, ldjf_p = _to_x(v, flow_params,
                                                 scaler_params)
        finite = jnp.isfinite(ldj_p) & jnp.all(jnp.isfinite(x_p), axis=1)
        x_safe = jnp.where(finite[:, None], x_p, fallback_x)
        logp = jnp.where(finite, log_prior(x_safe), -jnp.inf)
        finite = finite & jnp.isfinite(logp)
        logl = log_like(x_safe, finite)
        logt = beta * logl + logp + ldj_p + ldjf_p
        ok = finite & jnp.isfinite(logl)
        total = jnp.sum(jnp.where(ok, logt, 0.0))
        return total, (u_p, x_p, x_safe, ldj_p, theta_p, ldjf_p, logp,
                       logl, finite)

    def _grad_target(v, beta, fallback_x, flow_params, scaler_params):
        """(grad, aux) of the v-space log-target; grad sanitized to 0 on
        non-finite rows (those proposals are rejected anyway)."""
        primal, vjp_fn, aux = jax.vjp(
            lambda vv: _target_sum(vv, beta, fallback_x, flow_params,
                                   scaler_params), v, has_aux=True)
        g = vjp_fn(jnp.asarray(1.0, primal.dtype))[0]
        return jnp.where(jnp.isfinite(g), g, 0.0), aux

    def propose(st: SweepState, beta, geom, flow_params,
                scaler_params=None):
        """Draw proposals and compute everything that does NOT require the
        likelihood: proposal points in all three spaces, Jacobians, prior,
        finite masks, Student-t quadratic forms, fresh RNG key. (The MALA
        branch is the exception: its gradient pass evaluates the traced
        likelihood, so the proposal's logl rides along in the dict.)"""
        inv_cov = geom.get("t_inv_cov")
        t_chol = geom.get("t_chol")
        nu = geom.get("t_nu")
        n_chol = geom.get("normal_chol")

        key, k_gamma, k_norm, k_unif = jax.random.split(st.key, 4)
        n = st.u.shape[0]
        cur = st.theta if preconditioned else st.u

        if kind == "mala":
            # preconditioned Langevin: mass matrix M = geometry normal
            # covariance (M = L L^T), drift (sigma^2/2) M grad, noise
            # sigma L z; asymmetric-proposal Metropolis correction below.
            q = jnp.zeros(n, cur.dtype)
            drift = 0.5 * st.sigma**2 * ((st.grad @ n_chol) @ n_chol.T)
            z = jax.random.normal(k_norm, (n, n_dim), dtype=cur.dtype)
            v_prime = cur + drift + st.sigma * (z @ n_chol.T)

            grad_p, aux = _grad_target(v_prime, beta, st.x, flow_params,
                                       scaler_params)
            u_p, x_p, x_safe, ldj_p, theta_p, ldjf_p, logp_p, logl_p, \
                finite = aux
            # log q(v|v') - log q(v'|v), both N(.; center, sigma^2 M):
            # forward residual is sigma L z by construction
            drift_p = 0.5 * st.sigma**2 * ((grad_p @ n_chol) @ n_chol.T)
            r = cur - v_prime - drift_p
            w = solve_triangular(n_chol, r.T, lower=True).T
            corr = (-0.5 * jnp.sum(w * w, axis=-1) / st.sigma**2
                    + 0.5 * jnp.sum(z * z, axis=-1))
            # `finite` stays the pre-likelihood mask: call counting must
            # include rows whose likelihood evaluated to -inf (reference
            # mcmc.py:113-121 semantics)
            return dict(u=u_p, x=x_p, x_safe=x_safe, logdetj=ldj_p,
                        theta=theta_p, logdetj_flow=ldjf_p, logp=logp_p,
                        finite=finite, q=q, qp=q,
                        corr=corr, grad=grad_p, logl=logl_p,
                        k_unif=k_unif, key=key)

        if kind == "hmc":
            # Hamiltonian proposal: leapfrog with unit mass in the
            # geometry-whitened coordinates y = L^-1 v (equivalent to
            # mass matrix M = cov^-1 in v-space); eps = st.sigma. The
            # trajectory length is JITTERED uniformly in 1..n_leapfrog
            # per sweep step (traced fori bound) — fixed-length HMC can
            # resonate with the target's periods and jittering is the
            # standard cure (Neal 2011 s3.2). Volume-preserving +
            # symmetric, so the Metropolis correction is the kinetic-
            # energy difference only. Out-of-support intermediate points
            # contribute zero gradient (the trajectory coasts) and an
            # invalid endpoint is rejected by the -inf target.
            q = jnp.zeros(n, cur.dtype)
            eps = st.sigma
            k_norm, k_len = jax.random.split(k_norm)
            n_leap = jax.random.randint(k_len, (), 1, n_leapfrog + 1)
            z = jax.random.normal(k_norm, (n, n_dim), dtype=cur.dtype)
            y0 = solve_triangular(n_chol, cur.T, lower=True).T
            g_y0 = st.grad @ n_chol            # L^T grad_v, row form
            p0 = z + 0.5 * eps * g_y0          # first half kick

            aux0 = (st.u, st.x, st.x, st.logdetj, st.theta,
                    st.logdetj_flow, st.logp, st.logl,
                    jnp.ones(n, bool))
            calls0 = jnp.asarray(0, st.calls.dtype)

            def leap(_, carry):
                y, p, g_y, calls_in, _aux = carry
                y = y + eps * p
                v = y @ n_chol.T
                g_v, aux = _grad_target(v, beta, st.x, flow_params,
                                        scaler_params)
                calls_in = calls_in + jnp.sum(aux[-1]).astype(calls_in.dtype)
                g_y = g_v @ n_chol
                p = p + eps * g_y              # full kick (corrected below)
                return (y, p, g_y, calls_in, aux)

            y, p, g_y, calls_in, aux = jax.lax.fori_loop(
                0, n_leap, leap, (y0, p0, g_y0, calls0, aux0))
            p = p - 0.5 * eps * g_y            # trailing half kick
            u_p, x_p, x_safe, ldj_p, theta_p, ldjf_p, logp_p, logl_p, \
                finite = aux
            # need grad_v at the endpoint for the next step's carry
            grad_p = (g_y @ jax.scipy.linalg.solve_triangular(
                n_chol, jnp.eye(n_dim, dtype=cur.dtype), lower=True))
            corr = (0.5 * jnp.sum(z * z, axis=-1)
                    - 0.5 * jnp.sum(p * p, axis=-1))
            return dict(u=u_p, x=x_p, x_safe=x_safe, logdetj=ldj_p,
                        theta=theta_p, logdetj_flow=ldjf_p, logp=logp_p,
                        finite=finite, q=q, qp=q,
                        corr=corr, grad=grad_p, logl=logl_p,
                        k_unif=k_unif, key=key,
                        extra_calls=calls_in - jnp.sum(finite).astype(
                            calls_in.dtype))

        if kind == "tpcn":
            diff = cur - st.mu
            q = _student_quadform(diff, inv_cov)
            g = jax.random.gamma(k_gamma, 0.5 * (n_dim + nu), (n,), dtype=cur.dtype)
            s = (nu + q) / (2.0 * g)
            z = jax.random.normal(k_norm, (n, n_dim), dtype=cur.dtype)
            step = jnp.sqrt(s)[:, None] * (z @ t_chol.T)
            v_prime = st.mu + jnp.sqrt(1.0 - st.sigma**2) * diff + st.sigma * step
            use_imh = None
            if imh_every > 0:
                # independence-refresh step (see the imh_every rationale):
                # on every imh_every-th step the whole population proposes
                # theta' ~ N(0, I) in the flow latent instead of the local
                # t-pCN move. Both proposal laws are computed and selected
                # by `where` — under jit the step index is traced, and the
                # extra base draw is noise next to the likelihood.
                # Round-5 campaign outcome (RESULTS.md "imh_every
                # calibration"): refresh steps SUBSTITUTE for local
                # mutation inside the same stopping budget — a pure win
                # on near-Gaussian targets (gauss50 cadence 4: equal
                # raw-ladder error at 0.71x calls) and a real accuracy
                # loss on coverage-hard ones (funnel25: bridge -0.20 ->
                # -0.68 — refreshes are rejected in the neck while the
                # local steps they displaced go missing). A misfit<1
                # gate was measured and rejected: it blocks the gauss50
                # win (misfit sits at 1-2 there) without restoring the
                # funnel. Hence the cadence ships default-OFF and
                # explicit imh_every is the documented opt-in for
                # well-preconditioned targets.
                k_norm2 = jax.random.fold_in(k_norm, 1)
                v_imh = jax.random.normal(k_norm2, (n, n_dim),
                                          dtype=cur.dtype)
                use_imh = (st.i % imh_every) == (imh_every - 1)
                v_prime = jnp.where(use_imh, v_imh, v_prime)
        elif kind == "imh":
            # independent MH from the flow's base: theta' ~ N(0, I). A
            # well-trained flow maps the target onto ~N(0,I) latents, so
            # this is a GLOBAL move (mode hopping, zero autocorrelation
            # on accept); acceptance directly measures flow quality.
            q = jnp.zeros(n, cur.dtype)
            v_prime = jax.random.normal(k_norm, (n, n_dim), dtype=cur.dtype)
        else:
            q = jnp.zeros(n, cur.dtype)
            z = jax.random.normal(k_norm, (n, n_dim), dtype=cur.dtype)
            v_prime = cur + st.sigma * (z @ n_chol.T)

        u_p, x_p, ldj_p, theta_p, ldjf_p = _to_x(v_prime, flow_params,
                                                 scaler_params)

        finite = jnp.isfinite(ldj_p) & jnp.all(jnp.isfinite(x_p), axis=1)
        x_safe = jnp.where(finite[:, None], x_p, st.x)
        logp_p = jnp.where(finite, log_prior(x_safe), -jnp.inf)
        finite = finite & jnp.isfinite(logp_p)

        prop = dict(u=u_p, x=x_p, x_safe=x_safe, logdetj=ldj_p,
                    theta=theta_p, logdetj_flow=ldjf_p, logp=logp_p,
                    finite=finite, q=q, qp=q, k_unif=k_unif, key=key)
        if kind == "tpcn":
            prop["qp"] = _student_quadform(v_prime - st.mu, inv_cov)
            if imh_every > 0:
                prop["use_imh"] = use_imh
                # log q(theta) - log q(theta') under the N(0, I)
                # independence proposal (same correction as kind='imh');
                # computed on the PRE-WRAP latent positions
                prop["imh_corr"] = 0.5 * (jnp.sum(v_prime**2, axis=-1)
                                          - jnp.sum(cur**2, axis=-1))
        elif kind == "imh":
            # log q(theta) - log q(theta') under the N(0, I) proposal
            prop["corr"] = 0.5 * (jnp.sum(v_prime**2, axis=-1)
                                  - jnp.sum(cur**2, axis=-1))
        return prop

    def accept_update(st: SweepState, prop, logl_p, beta, geom) -> tuple:
        """Metropolis accept + diminishing adaptation + plateau counters.
        Returns (new_state, accept_mask, packed_stats) where packed_stats
        = [i, cnt, sigma, mean_alpha, corr, hot, resid, var_logl] as one
        f32 vector
        so the stepped host driver syncs ONE transfer per step instead of
        seven scalar pulls (each a full host-device round trip)."""
        nu = geom.get("t_nu")
        n = st.u.shape[0]
        i1 = (st.i + 1).astype(st.sigma.dtype)
        calls = st.calls + jnp.sum(prop["finite"])
        if "extra_calls" in prop:   # hmc: inner leapfrog evaluations
            calls = calls + prop["extra_calls"]

        log_ratio = (beta * (logl_p - st.logl)
                     + (prop["logp"] - st.logp)
                     + (prop["logdetj"] - st.logdetj))
        if preconditioned:
            log_ratio = log_ratio + (prop["logdetj_flow"] - st.logdetj_flow)
        if kind == "tpcn":
            half = 0.5 * (n_dim + nu)
            # log1p(q/nu) written as log(nu+q) - log(nu): the division
            # form overflows f32 when a blown-up quadform meets a small
            # nu (q/nu > 3e38 -> inf -> NaN ratios; cosmo30 seed-1
            # collapse, RESULTS.md round 5)
            A = -half * (jnp.log(nu + prop["qp"]) - jnp.log(nu))
            B = -half * (jnp.log(nu + prop["q"]) - jnp.log(nu))
            if imh_every > 0:
                # independence-refresh steps carry the N(0,I) proposal
                # correction instead of the t-pCN reversibility terms
                log_ratio = log_ratio + jnp.where(
                    prop["use_imh"], prop["imh_corr"], -A + B)
            else:
                log_ratio = log_ratio - A + B
            # Geometry-fit statistic for the adaptive sigma cap (see the
            # sigma_cap comment above): std over the live population of
            # log pi_v - log t_geom, both at the CURRENT positions (B is
            # log t_geom up to a constant, which std drops). 0 for a
            # perfect fit; O(1) nats once the t-geometry misses real
            # structure. Masked moments: a -inf row (infeasible particle
            # still in the population) must not poison the std.
            logpi_v = beta * st.logl + st.logp + st.logdetj
            if preconditioned:
                logpi_v = logpi_v + st.logdetj_flow
            mis_vals = logpi_v - B
            mis_ok = jnp.isfinite(mis_vals)
            mis_n = jnp.maximum(jnp.sum(mis_ok), 1)
            mis_mean = jnp.sum(jnp.where(mis_ok, mis_vals, 0.0)) / mis_n
            misfit = jnp.sqrt(jnp.sum(jnp.where(
                mis_ok, (mis_vals - mis_mean) ** 2, 0.0)) / mis_n)
            # cap interpolation: well-fit (misfit -> 0) frees sigma to
            # sigma_cap; misfit >~ 2 nats collapses it to the reference's
            # local-move scale. exp(-misfit^2/2) crosses 0.6 at 1 nat.
            # The local end clamps to sigma_cap too: at d < 6,
            # 2.38/sqrt(d) > 1 and an uncapped end puts sigma past the
            # sqrt(1-sigma^2) domain edge (NaN proposals).
            _loc = min(sqrt_d_scale, sigma_cap)
            _tpcn_cap = _loc + (sigma_cap - _loc) \
                * jnp.exp(-0.5 * misfit ** 2)
            misfit_st = misfit.astype(st.sigma.dtype)
        elif kind in ("mala", "hmc", "imh"):
            log_ratio = log_ratio + prop["corr"]
            misfit_st = st.misfit
        else:
            misfit_st = st.misfit

        alpha = jnp.minimum(1.0, jnp.exp(log_ratio))
        alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
        accept = jax.random.uniform(prop["k_unif"], (n,), dtype=alpha.dtype) < alpha

        sel = lambda a, b: jnp.where(accept[:, None] if a.ndim == 2 else accept, a, b)
        u = sel(prop["u"], st.u)
        x = sel(prop["x"], st.x)
        logdetj = sel(prop["logdetj"], st.logdetj)
        logl = sel(logl_p, st.logl)
        logp = sel(prop["logp"], st.logp)
        theta = sel(prop["theta"], st.theta)
        ldjf = sel(prop["logdetj_flow"], st.logdetj_flow)
        grad = (sel(prop["grad"], st.grad) if kind in ("mala", "hmc")
                else st.grad)

        alpha_mean = jnp.mean(alpha)
        if kind == "tpcn":
            # diminishing adaptation, misfit-adaptive cap (vs the
            # reference's fixed 2.38/sqrt(d), mcmc.py:152)
            sigma = jnp.abs(jnp.minimum(
                st.sigma + (alpha_mean - accept_target) / i1**0.75,
                _tpcn_cap))
            if imh_every > 0:
                # an independence step's acceptance measures FLOW quality,
                # not local scale — it must not drive sigma adaptation
                sigma = jnp.where(prop["use_imh"], st.sigma, sigma)
            if preconditioned:
                mu = st.mu + (jnp.mean(theta, axis=0) - st.mu) / i1
            else:
                mu = st.mu
        elif kind in ("mala", "hmc"):
            # uncapped: the Langevin/leapfrog step scale is problem-
            # dependent (~d^{-1/6}, ~d^{-1/4}), not the RW 2.38/sqrt(d)
            sigma = jnp.abs(st.sigma
                            + (alpha_mean - accept_target) / i1**0.75)
            mu = st.mu
        elif kind == "imh":
            sigma = st.sigma   # no proposal scale to adapt
            mu = st.mu
        else:
            if preconditioned:
                sigma = st.sigma + (alpha_mean - accept_target) / i1
            else:
                sigma = jnp.abs(st.sigma + (alpha_mean - accept_target) / i1)
            mu = st.mu

        # plateau metric: rwm variants include logdetj (mcmc.py:243,561)
        if kind == "rwm":
            vals = logl + logp + logdetj
        else:
            vals = logl + logp
        metric = jnp.mean(vals)
        # Significance-thresholded reset (plateau_z > 0): the reference
        # resets on ANY new record of the walker mean (mcmc.py:169-177),
        # but at stationarity the mean is pure noise and record statistics
        # alone extend every sweep to ~8 steps for a 5-step plateau
        # window; requiring the record to exceed the running best by
        # plateau_z standard errors only resets on statistically real
        # drift. plateau_z=0 reproduces the reference rule exactly.
        if plateau_z > 0.0:
            sem = jnp.std(vals) / jnp.sqrt(1.0 * n)
            improved = metric > st.logp2 + plateau_z * sem
        else:
            improved = metric > st.logp2
        cnt = jnp.where(improved, 0, st.cnt + 1)
        logp2 = jnp.maximum(st.logp2, metric)

        if corr_threshold > 0.0:
            corr = _batch_corr(st.v0, u)
        else:
            corr = st.corr

        # Equilibrium-drift test (calib_z > 0), evaluated each time a
        # CALIB_W-step window closes. A resampled population is
        # selected-hot: duplicates of high-logl particles whose residual
        # bias each later reweighting inherits (measured, RESULTS.md
        # round 3: gauss50 stage means sit +2..+7.5 SE above the analytic
        # tempered expectation and the SMC logz ladder compounds +2 nats,
        # because dlogZ/dbeta = E_beta[logl] exactly). While the sweep is
        # still relaxing that bias away, the population MOVES coherently;
        # at equilibrium it only jitters. The test: per-walker PAIRED
        # displacements over the last window — mean logl drift, and
        # per-dimension first/second-moment drift in u space. Pairing is
        # what gives the test its power exactly where mixing is slow: the
        # paired SE carries a sqrt(2(1-rho)) factor (rho = walker-level
        # window autocorrelation), so a slow coherent relaxation that an
        # unpaired population test drowns in std(logl) reads tens of
        # sigma here (measured, funnel25 mid-ladder: unpaired |z| < 2
        # while the neck dimension drifts at paired |z| ~ 10). TWO-SIDED:
        # selection bias is hot, but equilibration into a funnel neck
        # moves mean logl either way. At stationarity every statistic is
        # a calibrated N(0,1) and the test goes quiet, so easy targets
        # exit on the plateau rule before a second window even closes.
        # Per-walker refresh flags (imh_every): an ACCEPTED independence
        # move replaces the walker with a fresh flow draw; its paired
        # displacement is not local relaxation. Unmasked, those rows
        # inflate the paired variances and blind the drift test exactly
        # where it guards rung placement (measured, funnel25: ladder
        # -1.65 -> -2.29, rungs 34 -> 22; RESULTS.md round 4
        # "independence refresh"). MH itself protects poorly-covered
        # regions (a refresh OUT of a neck is rejected), so the walkers
        # that still carry coherent drift are exactly the never-refreshed
        # ones the masked test keeps.
        if imh_every > 0:
            fresh_upd = jnp.where(prop["use_imh"],
                                  jnp.maximum(st.fresh,
                                              accept.astype(sigma.dtype)),
                                  st.fresh)
        else:
            fresh_upd = st.fresh
        if calib_z > 0.0:
            i1i = st.i + 1
            full = (i1i - st.i_snap) >= CALIB_W
            ok = (jnp.isfinite(logl) & jnp.isfinite(st.logl_snap)
                  & (fresh_upd < 0.5))
            # Refresh-dominated windows (imh_every with a well-fit
            # flow): at high independence-move acceptance nearly every
            # walker refreshes within one window — P(never refreshed
            # over CALIB_W steps) ~ (1-acc)^(CALIB_W/imh_every), e.g.
            # 0.008 at acc=0.8, imh_every=2 — and the masked test is
            # left with 1-2 rows whose heavy-tailed z's fire
            # spuriously, pinning hot=1 and stretching 4-step sweeps
            # to 40+ (measured: d=4 Gaussian, calls 9.2k -> 17.5k;
            # RESULTS.md round 5). A mostly-refreshed population is
            # decorrelated BY CONSTRUCTION, so the window reads QUIET
            # (and resid -> 0) unless enough never-refreshed rows
            # exist for the drift statistics to mean anything.
            enough = jnp.sum(ok) >= min(MIN_CALIB_N, max(2, n // 8))
            nn = jnp.maximum(jnp.sum(ok), 2).astype(sigma.dtype)
            dl = jnp.where(ok, logl - st.logl_snap, 0.0)
            D = jnp.sum(dl) / nn
            var_dl = jnp.sum(jnp.where(ok, (dl - D) ** 2, 0.0)) / nn
            z_logl = jnp.abs(D) / jnp.maximum(
                jnp.sqrt(var_dl / nn), 1e-30)
            # per-dim paired drift of the mean and of the second moment
            # (funnel-type geometries expand a marginal's spread long
            # after its mean has settled); max over 2d scores gets a +1
            # threshold inflation for multiple testing (the max of ~2d
            # null z's concentrates near sqrt(2 ln 2d)); refresh-masked
            # row moments, like the logl stats above
            w_ok = ok.astype(sigma.dtype)[:, None]
            du = (u - st.u_snap) * w_ok
            Dm = jnp.sum(du, axis=0) / nn
            var_mrow = jnp.sum(w_ok * (u - st.u_snap - Dm) ** 2,
                               axis=0) / nn
            z_m = jnp.abs(Dm) / jnp.maximum(
                jnp.sqrt(var_mrow / nn), 1e-30)
            ds = (u ** 2 - st.u_snap ** 2) * w_ok
            Dv = jnp.sum(ds, axis=0) / nn
            var_vrow = jnp.sum(w_ok * (u ** 2 - st.u_snap ** 2 - Dv) ** 2,
                               axis=0) / nn
            z_v = jnp.abs(Dv) / jnp.maximum(
                jnp.sqrt(var_vrow / nn), 1e-30)
            z_dim = jnp.maximum(jnp.max(z_m), jnp.max(z_v))
            # `enough` guard (see above): too few never-refreshed rows
            # -> the z's are not statistics; read the window as quiet
            z_logl = jnp.where(enough, z_logl, 0.0)
            z_dim = jnp.where(enough, z_dim, 0.0)
            fired = ((z_logl > calib_z)
                     | (z_dim > calib_z + 1.0)).astype(sigma.dtype)
            hot = jnp.where(full, fired, st.hot)
            # Residual-hotness extrapolation for the evidence-ladder bias
            # correction (ops/weights.py): if the window-scale memory is
            # rho_w = corr(logl_snap, logl_now), a geometric relaxation
            # still has D * rho_w/(1-rho_w) of mean-logl drift left to
            # go (NEGATIVE while a selection-hot stage relaxes downward:
            # resid = -hotness). Recorded per stage and ADDED (times
            # dbeta) to the next logz rung — whatever upward bias the
            # adaptive budget could not afford to mutate away, the
            # estimator removes. Clipped to
            # rho_w <= 0.9: beyond that the extrapolation is off the end
            # of its own data (and the drift test is still firing anyway).
            l0c = jnp.where(ok, st.logl_snap, 0.0)
            l1c = jnp.where(ok, logl, 0.0)
            m0 = jnp.sum(l0c) / nn
            m1 = jnp.sum(l1c) / nn
            cov01 = jnp.sum(jnp.where(
                ok, (l0c - m0) * (l1c - m1), 0.0)) / nn
            v0v = jnp.sum(jnp.where(ok, (l0c - m0) ** 2, 0.0)) / nn
            v1v = jnp.sum(jnp.where(ok, (l1c - m1) ** 2, 0.0)) / nn
            rho_w = cov01 / jnp.maximum(jnp.sqrt(v0v * v1v), 1e-30)
            rho_w = jnp.clip(rho_w, 0.0, 0.9)
            resid = jnp.where(
                full,
                jnp.where(enough, D * rho_w / (1.0 - rho_w), 0.0),
                st.resid)
            u_snap = jnp.where(full, u, st.u_snap)
            logl_snap = jnp.where(full, logl, st.logl_snap)
            i_snap = jnp.where(full, i1i, st.i_snap)
            z_logl_st = jnp.where(full, z_logl, st.z_logl)
            z_dim_st = jnp.where(full, z_dim, st.z_dim)
            # window close re-snapshots every walker, including refreshed
            # ones — their NEXT paired displacement is local again
            fresh_new = jnp.where(full, jnp.zeros_like(fresh_upd),
                                  fresh_upd)
        else:
            hot, resid = st.hot, st.resid
            u_snap, logl_snap, i_snap = st.u_snap, st.logl_snap, st.i_snap
            z_logl_st, z_dim_st = st.z_logl, st.z_dim
            fresh_new = fresh_upd

        new_st = SweepState(u, x, logdetj, logl, logp, theta, ldjf,
                            sigma, mu, grad, st.i + 1, cnt, logp2, calls,
                            alpha_mean, st.v0, corr, u_snap, logl_snap,
                            i_snap, hot, resid, z_logl_st, z_dim_st,
                            misfit_st, fresh_new, st.dbeta, prop["key"])
        # masked population variance of logl: the bias-rate stopping
        # rule's third factor (see `cond`), shipped to the stepped host
        # driver in the same packed transfer
        okv = jnp.isfinite(logl)
        nnv = jnp.maximum(jnp.sum(okv), 1).astype(sigma.dtype)
        mlv = jnp.sum(jnp.where(okv, logl, 0.0)) / nnv
        var_logl = jnp.sum(jnp.where(okv, (logl - mlv) ** 2, 0.0)) / nnv
        stats = jnp.stack([new_st.i.astype(sigma.dtype),
                           cnt.astype(sigma.dtype), sigma, alpha_mean,
                           corr.astype(sigma.dtype), hot, resid, var_logl])
        return new_st, accept, stats

    def cond(st: SweepState) -> jnp.ndarray:
        if kind in ("mala", "hmc", "imh"):
            # sigma has Langevin-step units, not RW units: the
            # (2.38/sqrt(d) / sigma)^2 window stretch is meaningless here
            thresh = jnp.asarray(n_steps, st.sigma.dtype)
        else:
            ratio = sqrt_d_scale / st.sigma
            if kind == "rwm" and preconditioned:
                ratio = jnp.minimum(1.0, ratio)
            # With the tpcn cap freed above 2.38/sqrt(d), ratio < 1
            # SHRINKS the plateau window below n_steps — correct (near-
            # independent proposals equilibrate in O(1) steps) but floored
            # at plateau_floor so the consecutive-non-improvement count
            # keeps enough samples to be a statistic at all (5 -> 4
            # measured on the quickstart across 5 seeds: calls 60.9k ->
            # 55.3k median at unchanged logz, with the corr criterion and
            # khat-triggered refinement backstopping the occasional
            # under-trained flow; RESULTS.md round 3 defaults campaign).
            thresh = jnp.maximum(n_steps * ratio**2, jnp.minimum(
                jnp.asarray(n_steps, st.sigma.dtype),
                jnp.asarray(plateau_floor, st.sigma.dtype)))
        keep = st.cnt < thresh
        if corr_threshold > 0.0:
            # Adaptive mutation budget: the plateau rule alone stops the
            # sweep once the walker-mean energy stalls, which on curved
            # geometries (funnels, strong nonlinear correlations) happens
            # long before the resampled duplicates have decorrelated —
            # the population then under-mixes at every temperature and
            # the evidence biases (measured: 25-D funnel logZ err -2.02
            # at the plateau default vs -0.99 under the reference rule).
            # Requiring the start-position correlation to ALSO fall below
            # corr_threshold keeps easy targets at the plateau-rule call
            # count (they decorrelate within the plateau window) while
            # hard geometries automatically buy more steps, up to n_max.
            # The threshold TIGHTENS as sigma frees past the local-move
            # scale (same ratio as the plateau-window stretch): at high
            # sigma each accepted move is a near-independent draw, so the
            # residual memory is mostly the NEVER-MOVED fraction — exact
            # duplicates of resampled hot particles, which the SMC logz
            # ladder compounds across stages (measured, gauss50: freeing
            # sigma WITHOUT tightening the target left a ~25% stuck atom
            # per stage and pushed the SMC evidence from +2.4 to +5.8
            # nats; see RESULTS.md round 3). Decorrelation steps are
            # exactly as cheap as sigma is high, so demanding more of
            # them where sigma is high costs little and buys iid-quality
            # stage populations.
            if kind == "tpcn":
                thr_eff = corr_threshold * jnp.minimum(
                    1.0, sqrt_d_scale / st.sigma)
            else:
                thr_eff = corr_threshold
            keep = keep | (st.corr > thr_eff)
            if bias_rate > 0.0:
                # Bias-rate stopping (closes the budget loop on its own
                # diagnostic): the round-3/4 dose-response law reads the
                # NEXT logz rung's walker-memory bias as
                # ~ corr * dbeta * Var(logl) * dbeta_next (verified
                # near-oracle on the gauss50 ladder, RESULTS.md round 4
                # "corrlaw postmortem"). Allocating a run-total budget of
                # bias_rate nats proportionally to path length (rung
                # share = dbeta, sum(dbeta) = 1) and using the current
                # rung as the dbeta_next yardstick gives the per-rung
                # rule: keep sweeping while corr * dbeta * Var(logl)
                # exceeds bias_rate. Unlike the blanket d-scaled
                # corr_threshold this spends steps exactly at the rungs
                # whose dbeta * Var is large enough to matter; the law's
                # config-dependent overprediction (up to ~3x) only makes
                # the rule conservative — it can over-mutate, never
                # under-correct a rung the way the corrlaw retro
                # correction (disqualified, same postmortem) could.
                # The bias_floor guard bounds that conservatism: at early
                # rungs Var(logl) is astronomical (quickstart rung 1:
                # O(1e6)) while the ACTUAL rung errors there are ~0
                # (oracle forensics, RESULTS.md round 4) — the unguarded
                # rule demanded corr < 4e-7, pinned those sweeps at n_max
                # and spent 5.8x the call budget (RESULTS.md round 4). Flooring
                # the demanded decorrelation at the unrelaxed blanket
                # target caps per-rung spending at what the old d-scaled
                # rule would have paid, so the rate rule can only
                # REALLOCATE the relaxed budget, never exceed the old one.
                okv = jnp.isfinite(st.logl)
                nnv = jnp.maximum(jnp.sum(okv), 1).astype(st.sigma.dtype)
                mlv = jnp.sum(jnp.where(okv, st.logl, 0.0)) / nnv
                vlv = jnp.sum(jnp.where(
                    okv, (st.logl - mlv) ** 2, 0.0)) / nnv
                rate_keep = st.corr * st.dbeta * vlv > bias_rate
                if bias_floor > 0.0:
                    if kind == "tpcn":
                        floor_eff = bias_floor * jnp.minimum(
                            1.0, sqrt_d_scale / st.sigma)
                    else:
                        floor_eff = bias_floor
                    rate_keep = rate_keep & (st.corr > floor_eff)
                keep = keep | rate_keep
        if calib_z > 0.0:
            # equilibrium-drift test (see accept_update): keep sweeping
            # while the last closed window showed statistically
            # significant coherent population drift
            keep = keep | (st.hot > 0.5)
            if bias_budget > 0.0:
                # Bias-budget stopping: the stage's residual hotness
                # biases the NEXT logz rung by ~dbeta_next * resid
                # (see the ladder correction in accept_update /
                # parallel/fused.py). Using the CURRENT rung size as the
                # dbeta_next yardstick (the reweight-side cap enforces
                # the estimate when it's wrong), keep sweeping while the
                # predicted inherited bias exceeds the per-rung budget —
                # a stopping rule driven by the measured remaining
                # relaxation instead of a blanket decorrelation target.
                keep = keep | (jnp.abs(st.resid) * st.dbeta > bias_budget)
        keep = keep & (st.i < n_max)
        return (st.i == 0) | keep

    def should_continue(i, cnt, sigma, corr=0.0, hot=0.0,
                        resid=0.0, dbeta=0.0, var_logl=0.0) -> bool:
        """Host-side copy of `cond` for the stepped driver."""
        if i == 0:
            return True
        if i >= n_max:
            return False
        if kind in ("mala", "hmc", "imh"):
            thresh = n_steps
        else:
            ratio = sqrt_d_scale / sigma
            if kind == "rwm" and preconditioned:
                ratio = min(1.0, ratio)
            thresh = max(n_steps * ratio**2, min(n_steps, plateau_floor))
        thr_eff = corr_threshold
        floor_eff = bias_floor
        if kind == "tpcn":
            scale = min(1.0, sqrt_d_scale / sigma)
            thr_eff = corr_threshold * scale
            floor_eff = bias_floor * scale
        return (cnt < thresh
                or (corr_threshold > 0.0 and corr > thr_eff)
                or (corr_threshold > 0.0 and bias_rate > 0.0
                    and corr * dbeta * var_logl > bias_rate
                    and (bias_floor <= 0.0 or corr > floor_eff))
                or (calib_z > 0.0 and hot > 0.5)
                or (calib_z > 0.0 and bias_budget > 0.0
                    and abs(resid) * dbeta > bias_budget))

    def init_state(u, x, logdetj, logl, logp, beta, sigma0, geom, key,
                   flow_params=None, scaler_params=None, dbeta=0.0):
        n = u.shape[0]
        dtype = u.dtype
        if preconditioned:
            theta0, ldjf0 = flow_fwd(flow_params, u)
        else:
            theta0 = jnp.zeros_like(u)
            ldjf0 = jnp.zeros(n, dtype)

        if kind == "tpcn":
            sigma0 = jnp.minimum(sigma0, 0.99)
            mu0 = geom["t_mean"]
        else:
            mu0 = jnp.zeros(n_dim, dtype)

        calls0 = jnp.asarray(
            0, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
        if kind in ("mala", "hmc"):
            # initial-point gradient; the extra likelihood pass is counted
            v0 = theta0 if preconditioned else u
            grad0, aux0 = _grad_target(v0, beta, x, flow_params,
                                       scaler_params)
            calls0 = calls0 + jnp.sum(aux0[-1]).astype(calls0.dtype)
        else:
            grad0 = jnp.zeros_like(u)

        metric0 = jnp.mean(logl + logp)
        if kind == "rwm":
            metric0 = jnp.mean(logl + logp + logdetj)

        return SweepState(
            u=u, x=x, logdetj=logdetj, logl=logl, logp=logp,
            theta=theta0, logdetj_flow=ldjf0,
            sigma=jnp.asarray(sigma0, dtype), mu=mu0.astype(dtype),
            grad=grad0,
            i=jnp.asarray(0, jnp.int32), cnt=jnp.asarray(0, jnp.int32),
            logp2=metric0,
            calls=calls0,
            accept=jnp.asarray(0.0, dtype),
            v0=u,
            corr=jnp.asarray(1.0, dtype),
            u_snap=u, logl_snap=logl,
            i_snap=jnp.asarray(0, jnp.int32),
            hot=jnp.asarray(0.0, dtype),
            resid=jnp.asarray(0.0, dtype),
            z_logl=jnp.asarray(0.0, dtype),
            z_dim=jnp.asarray(0.0, dtype),
            misfit=jnp.asarray(0.0, dtype),
            fresh=jnp.zeros(n, dtype),
            dbeta=jnp.asarray(dbeta, dtype), key=key,
        )

    def _final_resid(final: SweepState):
        """Residual-hotness at sweep EXIT, refreshed from the last
        PARTIAL drift window when it holds >= 2 steps.

        The in-loop resid only updates when a CALIB_W-step window closes
        (accept_update). Sweeps that exit earlier — every plateau-rule
        exit shorter than CALIB_W steps, i.e. the entire easy-target
        regime — report resid = 0 and the evidence ladder gets NO
        hotness correction exactly where sweeps are shortest and
        populations stay most selection-hot (measured: quickstart smcZ
        +0.48 while every sweep exits at 4-6 steps). The geometric
        extrapolation D * rho/(1-rho) is window-length consistent (for a
        per-step geometric relaxation, D over ANY gap paired with rho
        over the same gap extrapolates to the same remaining total), so
        the freshest partial window is both valid and strictly more
        current than a stale closed-window reading.

        Exposed as `resid_exit`, SEPARATE from the live `resid`: feeding
        this estimate into the LIVE rung correction changes stored
        weights and thereby the whole run trajectory (measured, r4: the
        quickstart ladder degraded +0.48 -> +0.98 and the chained
        Rosenbrock quadrupled its call count when wired live). It is
        instead stored per stage and applied RETROACTIVELY at evidence
        time (Particles.recorrected_logz), which re-lays the rung ladder
        without touching run dynamics."""
        if calib_z <= 0.0:
            return final.resid
        gap = final.i - final.i_snap
        ok = (jnp.isfinite(final.logl) & jnp.isfinite(final.logl_snap)
              & (final.fresh < 0.5))
        nn = jnp.maximum(jnp.sum(ok), 2).astype(final.sigma.dtype)
        dl = jnp.where(ok, final.logl - final.logl_snap, 0.0)
        D = jnp.sum(dl) / nn
        l0c = jnp.where(ok, final.logl_snap, 0.0)
        l1c = jnp.where(ok, final.logl, 0.0)
        m0 = jnp.sum(l0c) / nn
        m1 = jnp.sum(l1c) / nn
        cov01 = jnp.sum(jnp.where(
            ok, (l0c - m0) * (l1c - m1), 0.0)) / nn
        v0v = jnp.sum(jnp.where(ok, (l0c - m0) ** 2, 0.0)) / nn
        v1v = jnp.sum(jnp.where(ok, (l1c - m1) ** 2, 0.0)) / nn
        rho_w = cov01 / jnp.maximum(jnp.sqrt(v0v * v1v), 1e-30)
        rho_w = jnp.clip(rho_w, 0.0, 0.9)
        resid_part = D * rho_w / (1.0 - rho_w)
        return jnp.where(gap >= 2, resid_part, final.resid)

    def _results(final: SweepState):
        return dict(u=final.u, x=final.x, logdetj=final.logdetj,
                    logl=final.logl, logp=final.logp,
                    efficiency=final.sigma, accept=final.accept,
                    steps=final.i, calls=final.calls,
                    proposal_scale=final.sigma, corr=final.corr,
                    resid=final.resid, resid_exit=_final_resid(final),
                    hot=final.hot,
                    z_logl=final.z_logl, z_dim=final.z_dim,
                    misfit=final.misfit)

    def _sweep_impl(u, x, logdetj, logl, logp, beta, sigma0, geom, key,
                    flow_params=None, scaler_params=None, dbeta=0.0):
        init = init_state(u, x, logdetj, logl, logp, beta, sigma0, geom,
                          key, flow_params, scaler_params, dbeta=dbeta)

        def body(st: SweepState) -> SweepState:
            prop = propose(st, beta, geom, flow_params, scaler_params)
            # gradient kernels evaluated the likelihood inside their
            # gradient passes
            logl_p = (prop["logl"] if kind in ("mala", "hmc")
                      else log_like(prop["x_safe"], prop["finite"]))
            new_st, _, _ = accept_update(st, prop, logl_p, beta, geom)
            if live_stats:
                jax.debug.callback(_live_emit, new_st.i, new_st.cnt,
                                   new_st.sigma, new_st.accept,
                                   new_st.calls, ordered=False)
            return new_st

        final = jax.lax.while_loop(cond, body, init)
        return _results(final)

    sweep = jax.jit(_sweep_impl)
    # unjitted composition handle: the device-resident SMC iteration
    # (parallel/fused.py) embeds the sweep inside a larger jitted program
    sweep.raw = _sweep_impl

    # stepped-mode handles (host drives the loop; likelihood runs on host
    # BETWEEN these two jitted halves — used for blob tracking through
    # accept/reject)
    sweep.init_state = jax.jit(init_state)
    sweep.propose = jax.jit(propose)
    sweep.accept_update = jax.jit(accept_update)
    sweep.should_continue = should_continue
    sweep.results = _results
    return sweep
