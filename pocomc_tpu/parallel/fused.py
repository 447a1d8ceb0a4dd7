"""Device-resident SMC engine: each phase of a Preconditioned Monte Carlo
iteration is ONE jitted device program over a fixed-shape particle history.

Motivation: a host<->device interaction (dispatch plus a blocking sync)
can cost more than the marginal device work of a flow-training epoch, so
wall-clock becomes interaction-bound. The host-orchestrated Sampler
performs ~20 interactions per SMC iteration; this engine reduces an
iteration to three dispatches and a single blocking sync:

  A. reweight  : ESS/USS temperature bisection over the full history,
                 weight trimming (masked), dynamic-n_effective update,
                 top-K training-set selection              (one dispatch)
  B. train     : the whole flow fit (epoch while_loop, optimizer init,
                 early stopping, best-params tracking) plus the weighted
                 Student-t proposal-geometry fit            (one dispatch)
  C. mutate    : resample from the flat history weights, adaptive MCMC
                 sweep, history write, termination statistics
                                                            (one dispatch)

The persistent-sampling history lives on device in fixed-shape buffers
(T_max slots of n_active particles; validity by count) so no program ever
recompiles as the run grows. RNG enters as uint32 seeds folded into keys
inside the programs — the host never issues eager device ops.

Everything shards over the particle mesh (inputs carry shardings; XLA
inserts psum/all-gather collectives for the reductions, top_k and
resampling gathers). The reference's host loop being replaced:
/root/reference/pocomc/sampler.py:492-510 with phases at :550-805.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..ops.weights import (compute_logw_and_logz_jax, ess_jax, uss_jax,
                           trim_weights_jax)
from ..ops.resampling import systematic_resample_jax, multinomial_resample_jax
from ..models.geometry import _fit_geometry_impl
from ..models.flow import fit_pre_jax


class DeviceHistory(NamedTuple):
    """Fixed-shape device-resident persistent-sampling history."""
    u: jnp.ndarray        # (T_max, n, d)
    x: jnp.ndarray        # (T_max, n, d)
    logdetj: jnp.ndarray  # (T_max, n)
    logl: jnp.ndarray     # (T_max, n)
    logp: jnp.ndarray     # (T_max, n)
    beta: jnp.ndarray     # (T_max,)
    logz: jnp.ndarray     # (T_max,)
    t: jnp.ndarray        # scalar int32: filled slots


def init_history(t_max: int, n: int, d: int, dtype=jnp.float32) -> DeviceHistory:
    z2 = jnp.zeros((t_max, n, d), dtype)
    z1 = jnp.zeros((t_max, n), dtype)
    return DeviceHistory(u=z2, x=z2, logdetj=z1, logl=z1, logp=z1,
                         beta=jnp.zeros(t_max, dtype),
                         logz=jnp.zeros(t_max, dtype),
                         t=jnp.asarray(0, jnp.int32))


def history_from_numpy(u, x, logdetj, logl, logp, beta, logz,
                       t_max: int) -> DeviceHistory:
    """Build (host-side) padded buffers from stacked (t, n[, d]) history
    arrays and place them on device in one transfer batch."""
    t, n = logl.shape
    d = u.shape[-1]
    assert t <= t_max

    def pad(a):
        out = np.zeros((t_max,) + a.shape[1:], np.float32)
        out[:t] = a
        return out

    return DeviceHistory(
        u=jnp.asarray(pad(u)), x=jnp.asarray(pad(x)),
        logdetj=jnp.asarray(pad(logdetj)), logl=jnp.asarray(pad(logl)),
        logp=jnp.asarray(pad(logp)),
        beta=jnp.asarray(pad(beta.reshape(t, 1))[:, 0]),
        logz=jnp.asarray(pad(logz.reshape(t, 1))[:, 0]),
        t=jnp.asarray(t, jnp.int32))


@partial(jax.jit, static_argnames=("t_max",))
def grow_history(hist: DeviceHistory, t_max: int) -> DeviceHistory:
    """Double the slot capacity (rare; one recompile of the programs)."""
    old = hist.u.shape[0]
    pad2 = lambda a: jnp.concatenate(
        [a, jnp.zeros((t_max - old,) + a.shape[1:], a.dtype)], axis=0)
    return DeviceHistory(u=pad2(hist.u), x=pad2(hist.x),
                         logdetj=pad2(hist.logdetj), logl=pad2(hist.logl),
                         logp=pad2(hist.logp), beta=pad2(hist.beta),
                         logz=pad2(hist.logz), t=hist.t)


def push_history(hist: DeviceHistory, u, x, logdetj, logl, logp, beta, logz
                 ) -> DeviceHistory:
    """Write one iteration into slot hist.t (device, fixed shapes); the
    counter saturates at t_max rather than wrapping."""
    t_max = hist.logl.shape[0]
    t = jnp.minimum(hist.t, t_max - 1)
    upd2 = lambda buf, v: jax.lax.dynamic_update_slice(buf, v[None], (t, 0, 0))
    upd1 = lambda buf, v: jax.lax.dynamic_update_slice(buf, v[None], (t, 0))
    return DeviceHistory(
        u=upd2(hist.u, u), x=upd2(hist.x, x),
        logdetj=upd1(hist.logdetj, logdetj),
        logl=upd1(hist.logl, logl), logp=upd1(hist.logp, logp),
        beta=hist.beta.at[t].set(beta), logz=hist.logz.at[t].set(logz),
        t=jnp.minimum(hist.t + 1, t_max))


def _flat_weights_at(hist: DeviceHistory, valid_t, valid_flat, beta):
    """Normalized flat history weights + incremental logZ at temperature
    beta (multiple-IS estimator, reference particles.py:215-231)."""
    logw, logz = compute_logw_and_logz_jax(
        hist.logl, hist.beta, hist.logz, valid_t, beta)
    w = jnp.exp(logw - jnp.max(logw))
    w = jnp.where(valid_flat, w, 0.0)
    return w / jnp.sum(w), logz


def _metric_of(w, valid_flat, metric: str):
    if metric == "ess":
        return ess_jax(w)
    return uss_jax(w, jnp.sum(valid_flat))


# length of phase A's stats vector ([beta, logz, metric_at_beta,
# n_eff_next, uss_active]); the packed per-iteration sync vector is
# statsA ++ statsC and the host splits it at this offset
STATS_A_LEN = 5


def make_reweight_program(n_select: int, n_active: int, metric: str = "ess",
                          dynamic: bool = True, dynamic_ratio: float = 1.0,
                          trim_ess: float = 0.99, trim_bins: int = 1000,
                          n_bisect: int = 26, bias_budget: float = 0.0):
    """Phase A: temperature selection + trimming + training-set selection.

    Returns reweight(hist, n_effective, n_total) -> dict with
      beta, logz          device scalars (feed phase C)
      w_flat (S,)         trimmed, renormalized flat history weights
      u_sel (K, d)        top-K-weight particles (training + geometry set)
      w_sel (K,)          their renormalized weights
      terminated          device bool: the run's termination criterion
                          (reference sampler.py:526-547) already held
                          BEFORE this iteration — phase C turns the
                          iteration into a free no-op (pipelined
                          enqueue-ahead would otherwise overshoot by up
                          to 2*pipeline full sweeps of likelihood calls)
      stats (5,)          [beta, logz, metric_at_beta, n_eff_next, uss_active]

    Mirrors reference sampler.py:717-805 (bisection branches, dynamic
    n_effective, trim). Fixed-count bisection replaces the host's
    tolerance loop — statically shaped, converged far below the host's 1%
    metric tolerance.
    """

    def reweight(hist: DeviceHistory, n_effective, n_total,
                 resid_prev=0.0):
        T_max, n = hist.logl.shape
        valid_t = jnp.arange(T_max) < hist.t
        valid_flat = jnp.repeat(valid_t, n)
        t_prev = jnp.maximum(hist.t - 1, 0)
        beta_prev = hist.beta[t_prev]
        logz_prev = hist.logz[t_prev]
        one = jnp.asarray(1.0, hist.beta.dtype)

        w_prev, _ = _flat_weights_at(hist, valid_t, valid_flat, beta_prev)
        m_prev = _metric_of(w_prev, valid_flat, metric)
        w_one, _ = _flat_weights_at(hist, valid_t, valid_flat, one)
        m_one = _metric_of(w_one, valid_flat, metric)

        # continue while 1-beta >= 1e-4 OR metric(beta=1) < n_total
        # (reference sampler.py:526-547); once false it stays false (the
        # history only grows), so phase C may skip the whole iteration
        terminated = jnp.logical_not(
            (1.0 - beta_prev >= 1e-4) | (m_one < n_total))

        def body(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            w_mid, _ = _flat_weights_at(hist, valid_t, valid_flat, mid)
            m = _metric_of(w_mid, valid_flat, metric)
            pred = m >= n_effective
            return jnp.where(pred, mid, lo), jnp.where(pred, hi, mid)

        lo, hi = jax.lax.fori_loop(0, n_bisect, body, (beta_prev, one))
        beta_bisect = 0.5 * (lo + hi)
        beta = jnp.where(m_prev <= n_effective, beta_prev,
                         jnp.where(m_one >= n_effective, one, beta_bisect))
        if bias_budget > 0.0:
            # Coverage-targeted beta spacing: a rung inherits
            # dbeta * hotness of upward bias from its still-relaxing
            # source population (see the correction note below), so when
            # the latest sweep exited with large |resid_prev| — the
            # extrapolated REMAINING mean-logl drift — the ESS-chosen
            # step would lay a rung whose (corrected) bias estimate is
            # itself untrustworthy at that magnitude. Cap the advance so
            # each rung carries at most bias_budget nats of estimated
            # hotness: more, smaller rungs exactly where relaxation is
            # incomplete (the VERDICT-r3 curved-geometry prescription).
            # The 2^-8 progress floor bounds the ladder at ~256 extra
            # rungs even if resid never shrinks (a floored rung then
            # carries floor * |resid| nats — still corrected by the
            # stored-rung correction).
            adv = jnp.maximum(
                bias_budget / jnp.maximum(jnp.abs(resid_prev), 1e-12),
                2.0 ** -8)
            beta = jnp.where(beta > beta_prev,
                             jnp.minimum(beta, beta_prev + adv), beta)
        w, logz_new = _flat_weights_at(hist, valid_t, valid_flat, beta)
        m_at = _metric_of(w, valid_flat, metric)
        # reference keeps the previous running logZ when beta stalls
        # (sampler.py:752-757 + the host loop's logz carry-over).
        # Moving rungs get the residual-hotness correction: the latest
        # stage population is hot by ~(-resid_prev) nats (resid is the
        # sweep's paired-window extrapolation of the REMAINING mean-logl
        # drift, mcmc.py accept_update — negative while a selection-hot
        # population still relaxes downward), and since dlogZ/dbeta =
        # E_beta[logl] the rung inherits dbeta * hotness of UPWARD bias
        # (measured = 96% of the gauss50 ladder drift; RESULTS.md
        # round 3). Subtracting dbeta * hotness = ADDING dbeta * resid
        # (sign verified against the closed-form gauss50 oracle:
        # benchmarks/smc_evidence_gauss50.py prints resid vs oracle hot
        # per stage). Corrected values are STORED so later rungs, MIS
        # weights, and beta selection stay self-consistent.
        logz = jnp.where(beta == beta_prev, logz_prev,
                         logz_new + (beta - beta_prev) * resid_prev)

        # dynamic n_effective (reference sampler.py:783-790); int() = trunc
        nu_active = uss_jax(w, n_active)
        if dynamic:
            low = n_active * (0.95 * dynamic_ratio)
            high = n_active * min(1.05 * dynamic_ratio, 1.0)
            n_eff_next = jnp.where(
                nu_active < low,
                jnp.trunc(n_active / nu_active * n_effective),
                jnp.where(nu_active > high,
                          jnp.trunc(nu_active / n_active * n_effective),
                          n_effective))
        else:
            n_eff_next = n_effective

        w_t = trim_weights_jax(w, valid_flat, ess=trim_ess, bins=trim_bins)

        w_sel, idx = jax.lax.top_k(w_t, n_select)
        w_sel = w_sel / jnp.sum(w_sel)
        d = hist.u.shape[-1]
        u_sel = hist.u.reshape(T_max * n, d)[idx]

        stats = jnp.stack([beta, logz, m_at, n_eff_next, nu_active])
        return dict(beta=beta, logz=logz, w_flat=w_t, u_sel=u_sel,
                    w_sel=w_sel, stats=stats, terminated=terminated)

    return jax.jit(reweight)


def make_train_program(flow, n_select: int, batch_size: int,
                       validation_split: float = 0.5, epochs: int = 5000,
                       patience: int = 10, learning_rate: float = 1e-3,
                       weight_decay: float = 0.0, clip_grad_norm: float = 1.0,
                       laplace_scale=None, gaussian_scale=None):
    """Phase B: the entire flow fit + weighted geometry fit as ONE program.

    Semantics mirror Flow.fit/models/flow.py (itself mirroring reference
    flow.py:165-384): shuffled validation split, AdamW with grad-norm
    clip, per-batch weighted NLL, on-device best-params snapshot, early
    stop after 1.5*patience stale epochs. The optimizer state is
    initialized INSIDE the program (the eager optax init costs ~100
    per-leaf dispatches). Unsupported here (falls
    back to the host fit): noise injection, LR-plateau annealing.

    Returns train(params, u_sel, w_sel, seed[, terminated])
      -> (best_params, geom dict, stats [n_done, best_loss]).

    `terminated` (phase A's device flag) skips the epoch while_loop —
    pipelined overshoot iterations always have train_now=True (beta has
    reached 1), and without the gate each paid the full flow fit, the
    most expensive per-iteration program. The skip naturally keeps the
    input params: best_loss stays inf, and the existing non-finite-fit
    guard rolls back to the inputs (and their pre-layer).
    """
    stop_after = int(1.5 * patience)
    n_train = int(validation_split * n_select) if validation_split > 0 \
        else n_select
    use_val = validation_split > 0
    n_val = n_select - n_train if use_val else 1
    bs = max(1, min(int(batch_size), n_train))
    bs = 1 << (bs.bit_length() - 1)
    n_batches = -(-n_train // bs)
    n_rows = n_batches * bs  # >= n_train; wrap-padded with zero weights
    n_dim = flow.n_dim

    tx = optax.chain(optax.clip_by_global_norm(clip_grad_norm),
                     optax.adamw(learning_rate, weight_decay=weight_decay))
    loss_fn = partial(flow._loss_fn, laplace_scale=laplace_scale,
                      gaussian_scale=gaussian_scale)

    whiten = bool(getattr(flow, "whiten", False))
    whiten_mode = getattr(flow, "whiten_mode", "full") or "full"

    def train(params, u_sel, w_sel, seed, terminated=None):
        key = jax.random.key(seed)
        k_shuf, k_epochs, k_geom = jax.random.split(key, 3)

        # Stock Flow params split into a closed-form whitening pre-layer
        # and the gradient-trained stack (Flow.fit does the same split);
        # custom device-ready flows without that split train whole.
        has_pre = (isinstance(params, dict) and "pre" in params
                   and "stack" in params)
        if has_pre:
            pre_prev = params["pre"]
            pre = (fit_pre_jax(u_sel, w_sel, mode=whiten_mode)
                   if whiten else pre_prev)
            with jax.default_matmul_precision("float32"):
                u_in = (u_sel - pre["mean"]) @ pre["w_fwd"]
            params = params["stack"]
        else:
            pre_prev = pre = None
            u_in = u_sel

        perm = jax.random.permutation(k_shuf, n_select)
        xs, ws = u_in[perm], w_sel[perm]
        wrap = jnp.arange(n_rows) % n_train
        xt = xs[:n_train][wrap]
        wt = jnp.where(jnp.arange(n_rows) < n_train, ws[:n_train][wrap], 0.0)
        if use_val:
            xv, wv = xs[n_train:], ws[n_train:]
        else:
            xv = jnp.zeros((1, n_dim), xs.dtype)
            wv = jnp.zeros((1,), ws.dtype)

        opt_state = tx.init(params)

        def one_epoch(carry):
            params, opt_state, key, best_params, best_loss, best_idx, ei = carry
            key, k_perm = jax.random.split(key)
            order = jax.random.permutation(k_perm, n_rows)
            xb = xt[order].reshape(n_batches, bs, n_dim)
            wb = wt[order].reshape(n_batches, bs)

            def step(c, batch):
                p, o = c
                loss, grads = jax.value_and_grad(loss_fn)(p, *batch)
                updates, o = tx.update(grads, o, p)
                return (optax.apply_updates(p, updates), o), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), (xb, wb))
            train_loss = jnp.sum(losses) / n_train
            current = (loss_fn(params, xv, wv) / n_val if use_val
                       else train_loss)
            improved = current < best_loss
            best_params = jax.tree_util.tree_map(
                lambda a, b: jnp.where(improved, a, b), params, best_params)
            best_loss = jnp.where(improved, current, best_loss)
            best_idx = jnp.where(improved, ei, best_idx)
            return (params, opt_state, key, best_params, best_loss,
                    best_idx, ei + 1)

        def cond(carry):
            ei, best_idx = carry[6], carry[5]
            return (ei < epochs) & (ei - 1 - best_idx < stop_after)

        carry0 = (params, opt_state, k_epochs, params,
                  jnp.asarray(jnp.inf, jnp.float32),
                  jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
        if terminated is None:
            final = jax.lax.while_loop(cond, one_epoch, carry0)
        else:
            final = jax.lax.cond(
                terminated, lambda c: c,
                lambda c: jax.lax.while_loop(cond, one_epoch, c), carry0)
        best_params, best_loss = final[3], final[4]
        n_done = final[6]
        # If no epoch ever reached a finite monitored loss, KEEP THE INPUT
        # params: the raw post-training params are NaN in that case and a
        # single such iteration would otherwise poison the flow (and with
        # it every subsequent proposal) for the rest of the run.
        best_params = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.isfinite(best_loss), a, b),
            best_params, params)
        if has_pre:
            # the kept stack matches the pre it was trained against: roll
            # the refit pre back too if training produced nothing finite
            pre_out = jax.tree_util.tree_map(
                lambda a, b: jnp.where(jnp.isfinite(best_loss), a, b),
                pre, pre_prev)
            full_params = {"pre": pre_out, "stack": best_params}
        else:
            full_params = best_params

        # proposal geometry in flow-latent space on the SAME weighted set
        # (reference sampler.py:671-672): weighted moments + Student-t EM
        theta, _ = flow._forward(full_params, u_sel)
        geom = _fit_geometry_impl(theta, w_sel, k_geom)

        stats = jnp.stack([n_done.astype(jnp.float32), best_loss])
        return full_params, geom, stats

    return jax.jit(train)


def make_mutate_program(sweep_raw, n_active: int, resample: str = "mult",
                        metric: str = "ess", preconditioned: bool = True):
    """Phase C: resample + adaptive MCMC sweep + history write +
    termination statistics, one dispatch.

    `sweep_raw` is the unjitted make_sweep product. For preconditioned
    runs `geom` comes from phase B; for plain runs it is fitted here on
    (u_sel, w_sel) each iteration (reference trains u_geometry every
    iteration in the else branch of sampler.py:636-678).

    Returns mutate(hist, beta, logz, w_flat, u_sel, w_sel, sigma0, geom,
    flow_params, seed[, scaler_params][, terminated][, statsA])
    -> (hist', stats) with stats = [accept, steps, calls, proposal_scale,
    metric_at_beta1, mean_logl_logp, noop, corr, resid, hot, z_logl,
    z_dim, nu, misfit, resid_exit].

    `statsA` (optional): phase A's (STATS_A_LEN,) stats vector. When
    given it is prepended to the returned stats so the host's blocking
    per-iteration sync pulls ONE packed device buffer instead of two —
    the sync is the pipelined loop's wall-clock floor.

    `terminated` (from phase A) makes the whole iteration a device-side
    no-op under `lax.cond`: the pipelined host enqueues up to 2*pipeline
    iterations past the termination point before it can observe it, and
    without the guard each of those ran a full sweep of likelihood calls
    (measured: +4k calls = the whole round-2 quickstart drift over the
    reference's 51,456). A skipped iteration leaves the history untouched
    and reports steps=calls=0, noop=1.
    """
    resampler = (multinomial_resample_jax if resample == "mult"
                 else systematic_resample_jax)

    def mutate(hist: DeviceHistory, beta, logz, w_flat, u_sel, w_sel,
               sigma0, geom, flow_params, seed, scaler_params=None,
               terminated=None, statsA=None):
        T_max, n, d = hist.u.shape
        key = jax.random.key(seed)
        k_res, k_geom, k_sweep = jax.random.split(key, 3)

        if not preconditioned:
            geom = _fit_geometry_impl(u_sel, w_sel, k_geom)

        def do_iter(hist):
            idx = resampler(k_res, n_active, w_flat)
            u = hist.u.reshape(T_max * n, d)[idx]
            x = hist.x.reshape(T_max * n, d)[idx]
            logdetj = hist.logdetj.reshape(-1)[idx]
            logl = hist.logl.reshape(-1)[idx]
            logp = hist.logp.reshape(-1)[idx]

            # current rung size: yardstick for the sweep's bias-budget
            # stopping rule (mcmc.py `cond`); hist still holds only the
            # PREVIOUS stages here (push happens below)
            t_prev = jnp.maximum(hist.t - 1, 0)
            dbeta = jnp.maximum(beta - hist.beta[t_prev], 0.0)
            res = sweep_raw(u, x, logdetj, logl, logp, beta, sigma0, geom,
                            k_sweep, flow_params=flow_params,
                            scaler_params=scaler_params, dbeta=dbeta)

            hist = push_history(hist, res["u"], res["x"], res["logdetj"],
                                res["logl"], res["logp"], beta, logz)
            s = jnp.stack([
                res["accept"], res["steps"].astype(jnp.float32),
                res["calls"].astype(jnp.float32), res["proposal_scale"],
                jnp.mean(res["logl"] + res["logp"]),
                jnp.asarray(0.0, jnp.float32),
                res["corr"].astype(jnp.float32),
                res["resid"].astype(jnp.float32),
                res["hot"].astype(jnp.float32),
                res["z_logl"].astype(jnp.float32),
                res["z_dim"].astype(jnp.float32),
                jnp.minimum(geom["t_nu"], 1e6).astype(jnp.float32),
                res["misfit"].astype(jnp.float32),
                res["resid_exit"].astype(jnp.float32)])
            return hist, s

        def skip_iter(hist):
            last = jnp.maximum(hist.t - 1, 0)
            lp_mean = jnp.mean(hist.logl[last] + hist.logp[last])
            zero = jnp.asarray(0.0, jnp.float32)
            s = jnp.stack([zero, zero, zero,
                           jnp.asarray(sigma0, jnp.float32),
                           lp_mean, jnp.asarray(1.0, jnp.float32),
                           zero, zero, zero, zero, zero, zero, zero, zero])
            return hist, s

        if terminated is None:
            hist, s = do_iter(hist)
        else:
            hist, s = jax.lax.cond(terminated, skip_iter, do_iter, hist)

        # termination metric: ESS/USS of the full updated history
        # reweighted to beta=1 (reference sampler.py:526-547)
        valid_t = jnp.arange(T_max) < hist.t
        valid_flat = jnp.repeat(valid_t, n)
        w1, _ = _flat_weights_at(hist, valid_t, valid_flat,
                                 jnp.asarray(1.0, hist.beta.dtype))
        m1 = _metric_of(w1, valid_flat, metric)

        stats = jnp.stack([s[0], s[1], s[2], s[3], m1, s[4], s[5], s[6],
                           s[7], s[8], s[9], s[10], s[11], s[12], s[13]])
        if statsA is not None:
            stats = jnp.concatenate([statsA, stats])
        return hist, stats

    return jax.jit(mutate)


def make_fused_iteration(sweep, flow, n_active: int, n_effective: float,
                         n_select: int = None):
    """One full SMC iteration (A+C with geometry refit) as a single device
    program — the multichip dry-run / compile-check entry. Production runs
    use the three-phase split above (training cadence is a host decision).
    """
    if n_select is None:
        n_select = n_active
    reweight_raw = make_reweight_program(n_select, n_active)
    mutate_raw = make_mutate_program(sweep.raw, n_active,
                                     preconditioned=True)

    def iteration(hist: DeviceHistory, sigma0, flow_params, seed):
        # n_total=inf: the dry-run iteration never self-terminates
        out = reweight_raw(hist, jnp.float32(n_effective),
                           jnp.float32(jnp.inf))
        theta, _ = flow._forward(flow_params, out["u_sel"])
        geom = _fit_geometry_impl(theta, out["w_sel"], jax.random.key(seed))
        hist, stats = mutate_raw(hist, out["beta"], out["logz"],
                                 out["w_flat"], out["u_sel"], out["w_sel"],
                                 sigma0, geom, flow_params, seed + 1)
        return hist, dict(beta=out["beta"], logz=out["logz"],
                          accept=stats[0], steps=stats[1].astype(jnp.int32),
                          calls=stats[2].astype(jnp.int32),
                          proposal_scale=stats[3])

    return jax.jit(iteration)
