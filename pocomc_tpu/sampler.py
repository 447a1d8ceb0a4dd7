"""Preconditioned Monte Carlo sampler (adaptive-temperature SMC) on JAX.

Orchestration mirrors the reference Sampler
(/root/reference/pocomc/sampler.py:18-1061): warmup from the prior, then a
persistent-sampling SMC loop of reweight (ESS-bisection temperature) ->
train (flow preconditioner) -> resample -> mutate (t-pCN / RWM MCMC), with
flow-importance-sampling evidence at the end. Same knob set and defaults.

Architecture:
  - the outer loop runs on host (O(tens) of iterations) over float64 numpy
    bookkeeping (temperature bisection, multiple-IS evidence, trimming) —
    these arrays are (T, n_active) tiny;
  - ALL hot compute is jitted on device: the adaptive MCMC sweep is one
    fused `lax.while_loop` program (see mcmc.py), flow training scans
    batches on device (models/flow.py), geometry fitting incl. Student-t
    EM is one program (models/geometry.py);
  - JAX-traceable likelihoods/priors compile straight into the sweep;
    black-box Python ones enter via `jax.pure_callback` (the host fan-out
    pool semantics of reference parallel.py are preserved there);
  - weight trimming (reference sampler.py:792) zeroes weights instead of
    physically shrinking arrays where static shapes matter, an equivalent
    estimator.

Sweep execution modes: the whole adaptive sweep is one fused
lax.while_loop program (black-box likelihoods enter it through
jax.pure_callback); when blobs are tracked the host drives the loop
between jitted propose/accept halves, preserving the reference's exact
blob accept/reject semantics (mcmc.py:113-149).
"""

from __future__ import annotations

import math
import pickle
from collections import OrderedDict
from functools import partial
from pathlib import Path
import os

import numpy as np
import jax
import jax.numpy as jnp

from .mcmc import make_sweep, make_loglike_device, f32_precision
from .models.flow import Flow
from .models.geometry import Geometry
from .particles import Particles
from .scaler import Reparameterize
from .ops.weights import (effective_sample_size, unique_sample_size,
                          trim_weights, bisect_beta,
                          logw_from_mis_denominator)
from .ops.resampling import systematic_resample, multinomial_resample
from .ops.psis import psislw
from .utils.tools import ProgressBar, FunctionWrapper
from .utils.validation import assert_array_2d, assert_array_float


def _is_traceable(fn, example_shape, expect_shape=None):
    """True if fn traces under jax.eval_shape with the right output shape."""
    try:
        out = jax.eval_shape(fn, jax.ShapeDtypeStruct(example_shape, jnp.float32))
        shape = jax.tree_util.tree_leaves(out)[0].shape
        if expect_shape is not None and tuple(shape) != tuple(expect_shape):
            return False
        return True
    except Exception:
        return False


# Module-level cache of jitted engine programs (sweeps, device-loop
# phases, warmup/evidence), keyed by everything baked into their traces:
# likelihood/prior identity, scaler/flow/kernel configuration. Re-jitting
# per Sampler instance would re-trace and rebuild every executable on each
# construction; with the scaler whitening moments passed as ARGUMENTS
# (scaler.whitening_params) the programs hold no per-instance state and
# are safely shareable.
# Entries hold strong references to the keyed objects so ids stay valid.
_ENGINE_CACHE: OrderedDict = OrderedDict()
_ENGINE_CACHE_MAX = 8

# Auto value of the bias_rate stopping rule (nats of predicted run-total
# ladder bias per unit beta; see the __init__ bias_rate rationale and
# mcmc.py `cond`). Calibrated on the north-star suite (RESULTS.md
# round 4 "bias-rate budget loop").
_BIAS_RATE_DEFAULT = 0.4
# Auto decorrelation floor of the bias_rate rule (see _bias_floor_value):
# the measured cost/accuracy knee of the floor dose-response on the
# gauss50/cosmo30 north stars (RESULTS.md round 4 "bias-rate budget
# loop").
_BIAS_FLOOR_DEFAULT = 0.10


def _cpu_worker_pool(n: int):
    """Spawn pool for `pool=<int>` whose workers keep JAX on the CPU.

    A worker that unpickles a jax.Array closed over by the user's
    likelihood would otherwise initialize the accelerator and reserve
    most of its memory, so the next worker could not start. The platform
    is pinned through the environment the workers inherit, so it holds
    before their interpreter imports anything. Spawn, not fork: forking
    a process that has initialized JAX deadlocks."""
    import multiprocessing as mp
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        return mp.get_context("spawn").Pool(n)
    finally:
        if saved is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = saved


def make_logprior_device(prior, n: int):
    """Device-usable log-prior: traced if possible, else pure_callback.
    Traced priors run at matmul precision 'float32' like the likelihood
    (see mcmc.make_loglike_device for the bf16-default rationale)."""
    if (getattr(prior, "traceable", False)
            or _is_traceable(prior.logpdf, (n, prior.dim), (n,))):
        traced = f32_precision(prior.logpdf)
        traced._pocomc_traced = True
        return traced

    def host(x):
        return np.asarray(prior.logpdf(np.asarray(x)), dtype=np.float32).reshape(-1)

    def device(x):
        return jax.pure_callback(host, jax.ShapeDtypeStruct((x.shape[0],), jnp.float32), x)

    return device


@partial(jax.jit, static_argnames=("n_boot",))
def _bootstrap_dlogz(logw, key, n_boot):
    """Std of bootstrap-resampled logsumexp(logw) - log n (device)."""
    n = logw.shape[0]
    idx = jax.random.randint(key, (n_boot, n), 0, n)
    bs = logw[idx]
    lz = jax.scipy.special.logsumexp(bs, axis=1) - jnp.log(n)
    return jnp.std(lz)


class Sampler:
    """Preconditioned Monte Carlo.

    Same public surface as the reference Sampler (sampler.py:154-373):
    __init__ knobs, run(), posterior(), evidence(), results, save_state(),
    load_state().
    """

    def __init__(self,
                 prior,
                 likelihood,
                 n_dim: int = None,
                 n_effective: int = 512,
                 n_active: int = 256,
                 likelihood_args: list = None,
                 likelihood_kwargs: dict = None,
                 vectorize: bool = False,
                 blobs_dtype=None,
                 periodic: list = None,
                 reflective: list = None,
                 transform: str = "probit",
                 pool=None,
                 flow: str = "nsf6",
                 train_config: dict = None,
                 train_frequency: int = None,
                 precondition: bool = True,
                 dynamic: bool = True,
                 metric: str = "ess",
                 n_prior: int = None,
                 sample: str = "tpcn",
                 n_leapfrog: int = 5,
                 n_steps: int = None,
                 n_max_steps: int = None,
                 plateau_z: float = 0.75,
                 plateau_floor: float = 4.0,
                 corr_threshold: float = None,
                 calib_z: float = 3.0,
                 bias_budget: float = None,
                 bias_rate: float = None,
                 bias_floor: float = None,
                 imh_every: int = None,
                 resample: str = "mult",
                 evidence_method: str = "auto",
                 evidence_refine: int = 2,
                 evidence_proposal: str = "auto",
                 evidence_nu: float = 5.0,
                 evidence_bridge="auto",
                 bridge_n: int = None,
                 bridge_steps: int = None,
                 output_dir: str = None,
                 output_label: str = None,
                 random_state: int = None,
                 mesh=None,
                 device_loop="auto",
                 pipeline: int = 1,
                 compile_cache: bool = True,
                 profile_dir: str = None,
                 # accepted for reference API compatibility (no-ops here)
                 pytorch_threads=None,
                 n_ess: int = None,
                 ):
        if n_ess is not None:
            import warnings
            warnings.warn("n_ess is deprecated. Use n_effective instead.",
                          DeprecationWarning, stacklevel=2)
            n_effective = n_ess

        # Device mesh (particles sharded over chips; parallel/mesh.py).
        self.mesh = mesh

        self.random_state = random_state
        seed = random_state if random_state is not None else int.from_bytes(os.urandom(4), "little")
        if self.mesh is not None and self.mesh.multihost:
            # replicated-host SPMD contract (parallel/mesh.py): every
            # process must follow the identical host RNG stream, so an
            # unseeded run takes process 0's entropy everywhere
            from jax.experimental import multihost_utils
            seed = int(multihost_utils.broadcast_one_to_all(
                np.uint32(seed)))
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.key(seed)

        # Prior (duck-typed protocol: logpdf / rvs / bounds / dim)
        self.prior = prior
        self.log_prior = prior.logpdf
        self.sample_prior = prior.rvs
        self.bounds = prior.bounds

        self.log_likelihood = FunctionWrapper(likelihood, likelihood_args,
                                              likelihood_kwargs)

        self.blobs_dtype = blobs_dtype
        self.have_blobs = blobs_dtype is not None

        self.n_dim = int(prior.dim if n_dim is None else n_dim)
        # Eager validation of the duck-typed bounds array (the reference
        # validates scaler inputs through input_validation.py helpers; a
        # malformed custom-prior bounds surface should fail here, not as
        # a shape error deep inside the first sweep).
        self.bounds = assert_array_float(
            assert_array_2d(np.asarray(self.bounds, dtype=np.float64)))
        if self.bounds.shape != (self.n_dim, 2):
            raise ValueError(
                f"prior.bounds must have shape (n_dim, 2) = "
                f"({self.n_dim}, 2); got {self.bounds.shape}.")

        if n_active is None and n_effective is None:
            raise ValueError("At least one of n_active or n_effective must be provided.")
        self.n_active = int(n_effective // 2) if n_active is None else int(n_active)
        self.n_effective = int(2 * self.n_active) if n_effective is None else int(n_effective)
        if self.mesh is not None and self.n_active % self.mesh.size != 0:
            raise ValueError(
                f"n_active ({self.n_active}) must be divisible by the mesh "
                f"size ({self.mesh.size}) to shard particles evenly.")
        self.n_steps = int(self.n_dim // 2) if n_steps is None else int(n_steps)
        # Sweep cap: 10x the plateau window, but never below 100 — at
        # low d the 10x rule under-caps exactly the corr-bound curved
        # regime where steps are cheapest (measured: the 10-D chained
        # Rosenbrock's transition rungs exit at the old cap of 50 with
        # start-corr still 0.47-0.60, logZ err -0.80; at a 100-step cap
        # the same seed reads -0.26; RESULTS.md round 3). High-d caps
        # are unchanged (d >= 20 already has 10*n_steps >= 100).
        self.n_max_steps = (max(10 * self.n_steps, 100)
                            if n_max_steps is None else int(n_max_steps))
        # Plateau-reset significance threshold (in standard errors of the
        # walker mean). 0.0 reproduces the reference's any-record reset
        # (mcmc.py:169-177), whose stationary record statistics pad every
        # sweep by ~60% pure-noise steps (measured: 8.2 vs 5.2 mean
        # steps/iteration on the quickstart at identical posteriors/logZ).
        # The default requires a 0.75-sigma real improvement. See
        # mcmc.py accept_update.
        self.plateau_z = float(plateau_z)
        # Minimum plateau window (consecutive non-improving steps before
        # the plateau rule may stop a sweep); see mcmc.py `cond` for the
        # measured 5 -> 4 dose-response. Exposed for cost/accuracy tuning
        # alongside n_steps.
        if float(plateau_floor) < 1.0:
            raise ValueError(
                f"Invalid plateau_floor {plateau_floor!r}: must be >= 1.")
        self.plateau_floor = float(plateau_floor)
        # Adaptive mutation budget (beyond reference): a sweep may stop
        # only once the MAX over dims of |corr(start, now)| has fallen
        # below this threshold (max, not mean: averaging dilutes a
        # funnel's single pathological dimension; the max statistic's
        # null level is ~sqrt(2 ln d / n), see mcmc._batch_corr) — i.e.
        # the
        # resampled duplicates have measurably decorrelated. Easy targets
        # decorrelate within the plateau window (no extra cost); curved
        # geometries (funnels) automatically buy more steps, up to
        # n_max_steps. 0 disables (pure plateau rule). See mcmc.py cond.
        #
        # None = auto, resolved by DIMENSION: 0.5 * min(1, (10/d)^2),
        # floored at 0.02. The default mutation budget must scale with d
        # for the same reason the reference's plateau window does
        # (n_steps = d//2, mcmc.py:175): in higher dimension the beta
        # ladder is longer (more rungs compounding per-rung bias
        # ~ dbeta * corr_exit * Var_beta(dbeta*logl)) and the flow's
        # coverage risk grows, while at d ~ 10 the plateau rule already
        # reaches reference accuracy at reference cost. Calibrated on the
        # north-star suite (RESULTS.md round 3 "decorrelation
        # dose-response"): d=10 quickstart stays at the reference call
        # count; d=25 funnel err -2.19 -> -0.81; d=50 Gaussian SMC-ladder
        # evidence +2.17 -> +0.00.
        #
        # run(n_evidence=0) additionally caps the target at 0.15
        # (ladder-grade): there the SMC persistent-sampling ladder IS the
        # evidence estimator; the flow-IS estimator (n_evidence > 0)
        # never touches the ladder. Black-box likelihoods floor the auto
        # target at 0.15 instead of 0.02 — cost-aware, see
        # _corr_auto_value (resolved in _build_device_fns once
        # traceability is known).
        self._corr_auto = corr_threshold is None
        _ct = (self._corr_auto_value()
               if corr_threshold is None else float(corr_threshold))
        if not 0.0 <= _ct < 1.0:
            raise ValueError(
                f"Invalid corr_threshold {corr_threshold!r}: must be in "
                f"[0, 1).")
        self.corr_threshold = _ct
        # Equilibrium-drift test (beyond reference): keep sweeping while
        # the population still drifts coherently — paired per-walker
        # displacement tests (mean logl + per-dim u moments) over
        # mcmc.CALIB_W-step windows, significant at calib_z standard
        # errors. A still-relaxing population means the resampled start
        # was selection-biased; since dlogZ/dbeta = E_beta[logl], that
        # bias is exactly what compounds through the SMC evidence
        # ladder. At stationarity every statistic is a calibrated N(0,1)
        # and easy targets never pay for it. 0 disables. See mcmc.py
        # accept_update.
        if float(calib_z) < 0.0:
            raise ValueError(
                f"Invalid calib_z {calib_z!r}: must be >= 0.")
        self.calib_z = float(calib_z)
        # Per-rung evidence-bias budget (nats): caps the beta advance at
        # bias_budget / |resid| when the latest sweep exited with large
        # extrapolated remaining drift (coverage-targeted beta spacing;
        # see parallel/fused.py make_reweight_program). None -> auto
        # (enabled with the drift test, off when calib_z=0); 0 disables.
        if bias_budget is None:
            bias_budget = 0.1 if self.calib_z > 0.0 else 0.0
        if float(bias_budget) < 0.0:
            raise ValueError(
                f"Invalid bias_budget {bias_budget!r}: must be >= 0.")
        self.bias_budget = float(bias_budget)
        # Run-total ladder-bias rate budget (nats per unit beta; mcmc.py
        # `cond`): a sweep keeps mutating while the dose-response law's
        # predicted next-rung walker-memory bias, corr * dbeta *
        # Var(logl), exceeds this rate. Because sum(dbeta) = 1 over the
        # run, the rule bounds the PREDICTED run-total ladder bias by
        # bias_rate nats while spending steps only at the rungs whose
        # dbeta * Var(logl) is large — closing the mutation budget loop
        # on the measured bias law instead of the blanket d-scaled
        # decorrelation target (which _corr_auto_value then relaxes to
        # the 0.15 ladder-grade cap; measured: gauss50 36.9M -> ~7M
        # likelihood calls at unchanged evidence accuracy, RESULTS.md
        # round 4 "bias-rate budget loop"). None -> auto: enabled at 0.4
        # for traceable (device-fused) likelihoods where steps are
        # nearly free, disabled for black-box likelihoods (their
        # cost-aware 0.15 target keeps reference-scale call budgets;
        # resolved in _build_device_fns once traceability is known).
        # 0 disables.
        self._bias_rate_auto = bias_rate is None
        if bias_rate is None:
            bias_rate = _BIAS_RATE_DEFAULT if self.calib_z > 0.0 else 0.0
        if float(bias_rate) < 0.0:
            raise ValueError(
                f"Invalid bias_rate {bias_rate!r}: must be >= 0.")
        self.bias_rate = float(bias_rate)
        # Spending bound for the rate rule: the rule never demands corr
        # below this. None -> derived per-run in _build_device_fns (the
        # unrelaxed blanket auto target raised to the measured 0.10
        # knee, once traceability/n_evidence are known; see
        # _bias_floor_value); explicit values win and directly set the
        # cost/accuracy point (per-rung spending ~ ln(0.5/floor)).
        self._bias_floor_auto = bias_floor is None
        if bias_floor is not None and not 0.0 <= float(bias_floor) <= 1.0:
            raise ValueError(
                f"Invalid bias_floor {bias_floor!r}: must be in [0, 1].")
        self.bias_floor = 0.0 if bias_floor is None else float(bias_floor)
        # Independence-refresh cadence (mcmc.py imh_every): every k-th
        # tpcn sweep step proposes theta' ~ N(0, I) in the flow latent —
        # an accepted refresh erases walker memory outright, so the
        # decorrelation criteria are satisfiable in O(1/acceptance)
        # steps instead of O(1/(alpha*sigma^2)) local moves (measured:
        # gauss50 27.2M -> see RESULTS.md round 4 "independence
        # refresh"). None -> auto (resolved with the other cost-aware
        # knobs in _build_device_fns); 0 disables.
        self._imh_auto = imh_every is None
        if imh_every is None:
            imh_every = 0
        if not isinstance(imh_every, int) or imh_every < 0:
            raise ValueError(
                f"Invalid imh_every {imh_every!r}: must be an int >= 0.")
        self.imh_every = int(imh_every)

        self.n_total = None
        self.n_evidence = None

        self.particles = Particles(self.n_active, self.n_dim)
        self.t = 0

        # Pool for black-box likelihood fan-out
        self.pool = pool
        if pool is None or (isinstance(pool, int)
                            and not isinstance(pool, bool) and pool <= 1):
            # pool=1/0: serial evaluation, same as no pool
            self.pool = None
            self.distribute = map
        elif isinstance(pool, int) and not isinstance(pool, bool):
            self.pool = _cpu_worker_pool(pool)
            self.distribute = self.pool.map
        else:
            self.distribute = pool.map

        self.vectorize = vectorize
        if self.vectorize and self.have_blobs:
            raise ValueError("Cannot vectorize likelihood with blobs.")

        self.u_geometry = Geometry()
        self.theta_geometry = Geometry()

        # Flow + training schedule
        self.flow = Flow(self.n_dim, flow) if isinstance(flow, str) else flow
        # Train batch ceiling 1024 vs the reference's min(n_eff//2, 512):
        # measured BOTH ways (ADVICE r4 item; 8-seed funnel A/B,
        # RESULTS.md round 5). gauss50 marginally prefers 512 (khat 0.12-0.29 vs 0.17-0.44, ~3% fewer calls,
        # equal wall); funnel25 clearly prefers 1024 (flow-IS median
        # err -0.50 vs -1.00 over 8 seeds — the extra optimizer steps
        # at 512 overfit the bulk and under-cover the neck). 1024 keeps
        # the coverage-critical configs accurate; the runtime clamps
        # (sampler fit paths + flow.fit) bound it on small training
        # sets.
        self.train_config = dict(validation_split=0.5,
                                 epochs=5000,
                                 batch_size=1024,
                                 patience=int(self.n_dim),
                                 learning_rate=1e-3,
                                 annealing=False,
                                 gaussian_scale=None,
                                 laplace_scale=None,
                                 noise=None,
                                 shuffle=True,
                                 clip_grad_norm=1.0,
                                 verbose=0)
        if train_config is not None:
            self.train_config.update(train_config)
        if train_frequency is None:
            self.train_frequency = max(self.n_effective // (self.n_active * 2), 1)
        else:
            self.train_frequency = int(train_frequency)
        self.flow_untrained = True

        if transform not in ("probit", "logit"):
            raise ValueError(f"Invalid transform {transform}. Options are 'probit' or 'logit'.")
        self.scaler = Reparameterize(self.n_dim, bounds=self.bounds,
                                     periodic=periodic, reflective=reflective,
                                     transform=transform)

        self.output_dir = Path("states") if output_dir is None else Path(output_dir)
        self.output_label = "pmc" if output_label is None else output_label

        self.preconditioned = bool(precondition)

        if metric not in ("ess", "uss"):
            raise ValueError(f"Invalid metric {metric}. Options are 'ess' or 'uss'.")
        self.metric = metric

        self.dynamic = bool(dynamic)
        self.dynamic_ratio = unique_sample_size(
            np.ones(self.n_effective), k=self.n_active) / self.n_active

        # 'mala'/'hmc' are beyond-reference: preconditioned gradient
        # kernels with autodiff through the composed flow/scaler/
        # likelihood program (mcmc.py kind='mala'/'hmc'); they need a
        # JAX-traceable likelihood (checked in _build_device_fns, where
        # traceability is probed).
        # 'imh' (independent MH from the flow base) is beyond-reference
        # too: global mode-hopping moves whose acceptance measures flow
        # quality; works with black-box likelihoods but needs the flow
        # preconditioner.
        if sample not in ("tpcn", "rwm", "mala", "hmc", "imh"):
            raise ValueError(f"Invalid sample {sample}. Options are 'tpcn', "
                             f"'rwm', 'mala', 'hmc' or 'imh'.")
        if sample == "imh" and not precondition:
            raise ValueError(
                "sample='imh' proposes from the flow's latent base and "
                "requires precondition=True.")
        self.sample = sample
        if not isinstance(n_leapfrog, int) or n_leapfrog < 1:
            raise ValueError(
                f"Invalid n_leapfrog {n_leapfrog!r}: must be an int >= 1.")
        self.n_leapfrog = int(n_leapfrog)

        self.proposal_scale = 2.38 / math.sqrt(self.n_dim)

        if resample not in ("mult", "syst"):
            raise ValueError(f"Invalid resample {resample}. Options are 'mult' or 'syst'.")
        self.resample = resample

        # Evidence estimator: "auto" (default) applies Pareto-smoothed IS
        # (ops/psis.py) whenever the k-hat tail diagnostic exceeds 0.5 —
        # the framework applies its own remediation instead of warning the
        # user into doing it — and plain flow-IS (the reference's
        # sampler.py:869-920) below. "is"/"psis" force one estimator.
        # The k-hat diagnostic is computed either way, and k-hat > 0.7
        # (smoothing can no longer rescue the tail) always warns.
        # (Optimal bridge sampling between the flow and the posterior
        # history was built and MEASURED WORSE on every heavy-tail
        # config — when the flow/posterior overlap is poor it degenerates
        # with overconfident error bars; RESULTS.md "bridge-sampling
        # postmortem" — and deleted per the parity-code-is-debt rule.)
        # khat-triggered evidence refinement (beyond reference): when the
        # flow-IS tail diagnostic k-hat exceeds 0.7 — importance ratios
        # effectively have infinite variance, so the estimate cannot be
        # trusted at ANY n_evidence — the run extends itself (n_total
        # doubles, adding beta=1 history rungs that enrich the flow's
        # training set) and re-draws the evidence, up to this many
        # rounds. Measured on the 25-D funnel at otherwise pure defaults
        # (RESULTS.md round 3): logZ err -2.19 -> -1.20 -> -0.54 over two
        # rounds (257k -> 705k likelihood calls); clean runs never
        # trigger and pay nothing. 0 restores reference behavior
        # (warn only).
        if int(evidence_refine) < 0:
            raise ValueError(
                f"Invalid evidence_refine {evidence_refine!r}: must be a "
                f"non-negative integer.")
        self.evidence_refine = int(evidence_refine)
        self._refine_round = 0
        if evidence_method not in ("auto", "is", "psis"):
            raise ValueError(f"Invalid evidence_method {evidence_method}. "
                             f"Options are 'auto', 'is' or 'psis'.")
        self.evidence_method = evidence_method
        self.evidence_method_used = None
        self.evidence_khat = None
        # Evidence-draw proposal (beyond reference): the flow's Gaussian
        # latent under-covers target tails it never saw training data
        # in, which biases the finite-n flow-IS logZ LOW (the quickstart
        # floor of -0.10 at the default budget) and fattens the
        # importance-ratio tail (k-hat 0.5-0.9). "t" draws the evidence
        # samples from a Student-t_nu latent pushed through the SAME
        # trained flow — the IS identity holds for any proposal with
        # computable density, and the heavier radial tail restores
        # coverage where q << p. Measured (RESULTS.md round 3 "defensive
        # evidence proposal"): quickstart 4-seed mean err -0.09 -> -0.05
        # with k-hat down on every seed (one seed's raw-IS +1.11 outlier
        # at k-hat 0.88 became -0.04 at 0.46); neutral on the funnel.
        # "auto" resolves to "t" when the flow exposes the t-latent
        # sampler (all built-in flows; custom flows fall back to "flow").
        # "flow" reproduces the reference estimator exactly
        # (sampler.py:869-920).
        if evidence_proposal not in ("auto", "flow", "t"):
            raise ValueError(
                f"Invalid evidence_proposal {evidence_proposal!r}. Options "
                f"are 'auto', 'flow' or 't'.")
        if not (float(evidence_nu) > 0.0):
            raise ValueError(
                f"Invalid evidence_nu {evidence_nu!r}: must be > 0.")
        self.evidence_proposal = evidence_proposal
        self.evidence_nu = float(evidence_nu)
        self.evidence_proposal_used = None

        # Flow-anchored bridge evidence (bridge.py): the warped
        # temperature path that replaces the raw-ladder read-out of
        # run(n_evidence=0) when a trained flow exists. 'auto'/True run
        # it whenever prerequisites hold (precondition + traceable
        # likelihood+prior, single-host); False never.
        if evidence_bridge not in ("auto", True, False):
            raise ValueError(
                f"Invalid evidence_bridge {evidence_bridge!r}. Options "
                f"are 'auto', True or False.")
        self.evidence_bridge = evidence_bridge
        if bridge_n is None:
            # power-of-two bucket (CLAUDE.md shape rule), >= the active
            # population, capped at the flow-IS default draw size
            bridge_n = min(4096, max(1024, 2 * self.n_active))
            bridge_n = 1 << (bridge_n - 1).bit_length()
        if int(bridge_n) < 2:
            raise ValueError(
                f"Invalid bridge_n {bridge_n!r}: must be an int >= 2.")
        self.bridge_n = int(bridge_n)
        if bridge_steps is None:
            bridge_steps = 10
        if int(bridge_steps) < 1:
            raise ValueError(
                f"Invalid bridge_steps {bridge_steps!r}: must be >= 1.")
        self.bridge_steps = int(bridge_steps)
        self.bridge_diagnostics = None

        if n_prior is None:
            self.n_prior = int(2 * max(self.n_effective // self.n_active, 1) * self.n_active)
        else:
            self.n_prior = int(max(n_prior / self.n_active, 1) * self.n_active)
        self.prior_samples = None

        self.logz = None
        self.logz_err = None
        self.current_particles = None
        self.warmup = True
        self.calls = 0
        self.progress = None
        self.pbar = None

        if device_loop not in ("auto", True, False):
            raise ValueError(
                f"Invalid device_loop {device_loop!r}. Options are 'auto', "
                f"True or False.")
        self.device_loop = device_loop

        # Device-loop pipeline depth: how many iterations may be enqueued
        # ahead of the last synced statistics (0 = sync every iteration
        # before enqueueing the next, the pre-pipelining behavior). Since
        # an iteration is enqueued before its own predecessor syncs, host
        # adaptation inputs are stale by UP TO 2*pipeline iterations
        # (pipeline in flight + pipeline awaiting the batched drain), and
        # termination can overshoot by the same count (the extra
        # final-temperature samples are kept). See _run_device_loop.
        if not isinstance(pipeline, int) or pipeline < 0:
            raise ValueError(
                f"Invalid pipeline {pipeline!r}: must be an int >= 0.")
        self.pipeline = int(pipeline)

        # Cold-start: persistent XLA compile cache (fresh-process compiles
        # of the sweep/training programs become disk reads; utils/tools.py
        # enable_compile_cache). Opt out with compile_cache=False or
        # POCOMC_COMPILE_CACHE=off.
        if compile_cache:
            from .utils.tools import enable_compile_cache
            enable_compile_cache()

        # Observability: jax.profiler trace hooks (SURVEY.md section 5.1).
        # profile_dir=<dir> captures a full XLA trace of run() viewable in
        # TensorBoard/Perfetto; phase TraceAnnotations (reweight/train/
        # resample/mutate/evidence) label the timeline either way.
        self.profile_dir = None if profile_dir is None else str(profile_dir)

        self._build_device_fns()

        # eager check for an EXPLICIT bridge request (the 'auto' default
        # degrades silently to the recorrected ladder instead)
        if self.evidence_bridge is True and not self.preconditioned:
            raise ValueError(
                "evidence_bridge=True requires precondition=True (the "
                "bridge anneals in the flow's latent space). Use "
                "evidence_bridge='auto' to fall back to the ladder "
                "estimate instead.")

    # ------------------------------------------------------------------
    # device program construction
    # ------------------------------------------------------------------

    def _corr_auto_value(self, n_evidence=None):
        """Auto decorrelation target: 0.5 * min(1, (10/d)^2), floored at
        0.02 (see the __init__ corr_threshold rationale); capped at 0.15
        (ladder-grade) when run(n_evidence=0) makes the SMC
        persistent-sampling ladder the evidence estimator.

        Cost-aware floor: black-box likelihoods (host callbacks, pools,
        blobs — anything non-traceable) pay host work per call, so the
        aggressive high-d target (0.02 at d=50 costs ~37M calls on the
        gauss50 north star, vs the reference's ~1.7M) would turn an
        expensive likelihood into a multi-hour run for accuracy the user
        may not need. There the auto target floors at 0.15 instead:
        reference-parity accuracy at reference-scale call budgets
        (funnel25 err -0.99 = the reference's own reading, ~945k calls
        vs its 990k; gauss50 SMC-ladder +0.46, within the round-2 gate).
        Fused device likelihoods keep the full d-scaled target — there
        the extra calls are nearly free (RESULTS.md round 3). Explicit
        corr_threshold values always win over auto.

        Bias-rate handover: when the bias_rate stopping rule is active
        (mcmc.py `cond`) the blanket target relaxes to the 0.15
        ladder-grade cap — the rate rule buys decorrelation exactly at
        the rungs whose predicted ladder bias needs it, instead of the
        d-scaled target buying it at every rung (measured: gauss50
        36.9M -> ~7M calls at unchanged evidence accuracy; RESULTS.md
        round 4 "bias-rate budget loop").
        """
        base = min(0.5, max(0.02, 0.5 * (10.0 / self.n_dim) ** 2))
        if getattr(self, "bias_rate", 0.0) > 0.0:
            base = max(base, 0.15)
        if n_evidence == 0:
            base = min(base, 0.15)
        if not getattr(self, "likelihood_traceable", True):
            base = max(base, 0.15)
        return base

    def _bias_floor_value(self, n_evidence=None):
        """Decorrelation floor for the bias_rate stopping rule: the
        UNRELAXED blanket auto target (what _corr_auto_value would return
        with the rate rule off), raised to the measured 0.10
        cost/accuracy knee. The rule never demands corr below this.
        Without any floor the rule pinned quickstart's early rungs
        (Var(logl) ~ 1e6, actual rung error ~0) at n_max: 5.8x calls
        (RESULTS.md round 4). With the floor AT the old blanket target
        the rule could only reallocate the old budget — still brute-force at high
        d (gauss50 27.2M calls for +0.113 raw-ladder err). The 0.10 knee
        is where the dose-response bends (gauss50: floor 0.05 -> 25.4M
        calls / +0.024, 0.10 -> 6.95M / +0.212, 0.15=inert -> 5.0M /
        +0.301; cosmo30 at 0.10: 1.73M calls / smcZ +0.107 vs 17.8M at
        the round-3 blanket; RESULTS.md round 4 "bias-rate budget
        loop"). At d <= ~18 the blanket target itself is >= 0.15, the
        floor meets the (relaxed) threshold and the rule is provably
        inert — easy low-d targets keep the plateau-rule call count."""
        base = min(0.5, max(0.02, 0.5 * (10.0 / self.n_dim) ** 2))
        base = max(base, _BIAS_FLOOR_DEFAULT)
        if n_evidence == 0:
            base = min(base, 0.15)
        if not getattr(self, "likelihood_traceable", True):
            base = max(base, 0.15)
        return base

    def _build_device_fns(self):
        n = self.n_active
        like_traceable = False
        if self.pool is None and not self.have_blobs:
            if self.vectorize:
                like_traceable = _is_traceable(self.log_likelihood, (n, self.n_dim), (n,))
                self._like_batch_fn = self.log_likelihood
            else:
                if _is_traceable(self.log_likelihood, (self.n_dim,), ()):
                    self._like_batch_fn = jax.vmap(self.log_likelihood)
                    like_traceable = True
                else:
                    self._like_batch_fn = None
        else:
            self._like_batch_fn = None
        self.likelihood_traceable = like_traceable
        if getattr(self, "_bias_rate_auto", False):
            # Cost-aware resolution (see the __init__ bias_rate
            # rationale): the rate rule spends extra likelihood calls,
            # which are nearly free only when the likelihood fuses into
            # the device sweep. Must resolve before the auto
            # corr_threshold below (the blanket target relaxes only when
            # the rate rule is active) and before the programs are built.
            self.bias_rate = (_BIAS_RATE_DEFAULT
                              if self.calib_z > 0.0 and like_traceable
                              else 0.0)
        if getattr(self, "_corr_auto", False):
            # Cost-aware re-resolution: whether the likelihood traces (=
            # calls are nearly free on device) is only known here, after
            # the probe above. Must happen before the programs below are
            # built/fetched — corr_threshold is baked into their traces.
            self.corr_threshold = self._corr_auto_value(self.n_evidence)
        if getattr(self, "_bias_floor_auto", True):
            self.bias_floor = (self._bias_floor_value(self.n_evidence)
                               if self.bias_rate > 0.0 else 0.0)
        if getattr(self, "_imh_auto", False):
            # auto cadence: OFF by measurement (round-5 campaign,
            # RESULTS.md "imh_every calibration"): cadence 4 trades
            # equally on gauss50 (0.71x calls, same error) but costs
            # real accuracy on coverage-hard geometries (funnel25
            # bridge -0.20 -> -0.68), and no cheap statistic separates
            # the two regimes (a misfit<1 gate was measured and
            # rejected). Explicit imh_every=2..4 is the documented
            # opt-in for well-preconditioned targets.
            self.imh_every = 0

        if self.sample in ("mala", "hmc") and not like_traceable:
            raise ValueError(
                f"sample={self.sample!r} needs gradients of the likelihood, "
                f"so the likelihood must be JAX-traceable (no pools, no "
                f"blobs; see docs/likelihoods.md). Use 'tpcn' or 'rwm' for "
                f"black-box likelihoods.")

        if like_traceable:
            loglike_dev = make_loglike_device(self._like_batch_fn, True, True)
            self._loglike_dev = loglike_dev  # bridge evidence reuses it
        else:
            self._loglike_dev = None
            loglike_dev = make_loglike_device(self._host_like_raw, True, False)
            if self.mesh is not None:
                # multi-host/multi-chip black-box fan-out: each process's
                # Python likelihood sees only its local particle rows
                loglike_dev = self.mesh.shard_callback(loglike_dev)

        # Sweep execution mode: the fully-fused lax.while_loop (black-box
        # likelihoods enter it through jax.pure_callback); blob tracking
        # through accept/reject uses the stepped mode (host drives the
        # loop between jitted propose/accept halves).
        self._sweep_mode = "stepped" if self.have_blobs else "fused"

        logprior_dev = make_logprior_device(self.prior, n)
        self._logprior_dev = logprior_dev
        # host-facing prior eval: one jitted call when traceable, instead
        # of per-distribution eager dispatches
        prior_traceable = getattr(logprior_dev, "_pocomc_traced", False)
        if self.sample in ("mala", "hmc") and not prior_traceable:
            raise ValueError(
                f"sample={self.sample!r} differentiates through the prior "
                f"as well: a callback-based (non-traceable) prior cannot "
                f"provide gradients. Use JAX-native distributions "
                f"(pocomc_tpu.Normal, ...) or 'tpcn'/'rwm'.")
        if prior_traceable:
            self._logprior_host = jax.jit(logprior_dev)
        else:
            self._logprior_host = self.prior.logpdf

        # Device-resident SMC loop (parallel/fused.py): one dispatch per
        # phase, one blocking sync per iteration — requires everything in
        # the iteration (likelihood, prior, flow) to trace. Custom flow
        # objects (docs/flows.md "Custom flows") qualify only if they
        # expose the device-training surface; otherwise the host path
        # (flow.fit) drives them.
        flow_device_ready = all(
            hasattr(self.flow, a)
            for a in ("_sample", "_log_prob", "_loss_fn", "_forward",
                      "_config_key"))
        self._device_loop_ok = (like_traceable and prior_traceable
                                and not self.have_blobs
                                and flow_device_ready)
        if self.device_loop is True and not self._device_loop_ok:
            raise ValueError(
                "device_loop=True requires a JAX-traceable likelihood and "
                "prior, no blobs, and a flow exposing the device-training "
                "surface.")

        # Live per-step sweep stats (reference mcmc.py:159-167): every
        # fused sweep — including the device-resident loop's — emits its
        # packed stats each step through a debug callback. The sink is
        # looked up at call time, so the shared programs stay shareable
        # and the tap is a no-op whenever no sweep is being watched. Off
        # under mesh sharding (SPMD callback delivery is per-device).
        self._live_stats = self._sweep_mode == "fused" and self.mesh is None

        # Program store: the module-level shared entry when nothing
        # instance-bound is baked into the traces (traceable likelihood +
        # prior; scaler moments are arguments), else per-instance.
        if self._device_loop_ok:
            ekey = self._engine_key()
            entry = _ENGINE_CACHE.get(ekey)
            if entry is None:
                # pin every identity-keyed ingredient (fn, prior, args,
                # kwargs): id()/default-repr addresses must not be
                # recyclable while the cache entry lives
                entry = {"__refs__": (self.log_likelihood.f, self.prior,
                                      self.log_likelihood.args,
                                      self.log_likelihood.kwargs)}
                _ENGINE_CACHE[ekey] = entry
                while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
                    _ENGINE_CACHE.popitem(last=False)
            self._prog_cache = entry
        else:
            self._prog_cache = {}

        cache = self._prog_cache
        if "sweep_plain" not in cache:
            common = dict(scaler=self.scaler, log_prior=logprior_dev,
                          log_like=loglike_dev, n_dim=self.n_dim,
                          n_steps=self.n_steps, n_max=self.n_max_steps,
                          plateau_z=self.plateau_z,
                          plateau_floor=self.plateau_floor,
                          corr_threshold=self.corr_threshold,
                          calib_z=self.calib_z,
                          bias_budget=self.bias_budget,
                          bias_rate=self.bias_rate,
                          bias_floor=self.bias_floor,
                          live_stats=self._live_stats,
                          n_leapfrog=self.n_leapfrog,
                          imh_every=self.imh_every)
            # imh needs the flow; its (unreachable — precondition is
            # enforced) plain-space slot builds as tpcn
            cache["sweep_plain"] = make_sweep(
                kind="tpcn" if self.sample == "imh" else self.sample,
                preconditioned=False, **common)
            cache["sweep_precond"] = make_sweep(
                kind=self.sample, preconditioned=True,
                flow_fwd=self.flow.kernel_fwd,
                flow_inv=self.flow.kernel_inv, **common)
            scaler = self.scaler
            cache["scaler_fwd"] = jax.jit(
                lambda x, scp: scaler.forward(x, params=scp))
            cache["scaler_inv"] = jax.jit(
                lambda u, scp: scaler.inverse(u, params=scp))
            cache["loglike_host"] = (
                jax.jit(f32_precision(self._like_batch_fn))
                if like_traceable else None)
        self._sweep_plain = cache["sweep_plain"]
        self._sweep_precond = cache["sweep_precond"]
        self._scaler_forward = cache["scaler_fwd"]
        self._scaler_inverse = cache["scaler_inv"]
        self._loglike_host_jit = cache["loglike_host"]

        self._scp_cache = None
        self._geom_dev = None
        self._dev_iter_stats = []
        self._hist_dev = None
        self._slot_count = 0
        self._synced_slots = 0

    @staticmethod
    def _data_key(v):
        """Content-stable key for likelihood args/kwargs. repr() truncates
        large arrays ('...') and rounds floats, so value-distinct datasets
        could collide in the engine cache and silently reuse programs with
        another Sampler's data baked in as trace constants."""
        try:
            a = np.asarray(v)
            if a.dtype != object:
                import hashlib
                return (str(a.dtype), a.shape,
                        hashlib.sha1(a.tobytes()).hexdigest())
        except Exception:
            pass
        return repr(v)

    def _engine_key(self):
        """Everything baked into the shared jitted programs' traces."""
        sc = self.scaler
        like = self.log_likelihood
        return (
            # live_stats is a static flag of the sweep trace and differs
            # between mesh and non-mesh samplers
            self._live_stats,
            id(like.f), tuple(map(self._data_key, like.args)),
            tuple(sorted((k, self._data_key(v))
                         for k, v in like.kwargs.items())),
            self.vectorize, id(self.prior),
            self.n_dim, self.n_active, self.n_steps, self.n_max_steps,
            self.plateau_z, self.plateau_floor,
            self.corr_threshold, self.calib_z,
            self.bias_budget, self.bias_rate, self.bias_floor,
            self.imh_every, self.sample, self.n_leapfrog,
            self.preconditioned, self.metric, self.dynamic,
            float(self.dynamic_ratio), self.resample,
            self.flow._config_key,
            getattr(self.flow, "whiten_mode",
                    getattr(self.flow, "whiten", None)),
            sc.transform, sc.scale, sc.diagonal,
            np.asarray(sc.low).tobytes(), np.asarray(sc.high).tobytes(),
            np.asarray(sc.mask_periodic).tobytes(),
            np.asarray(sc.mask_reflective).tobytes(),
        )

    def _scp(self):
        """Device refs of the scaler whitening params (rebuilt after each
        scaler fit; passed as arguments to the shared programs)."""
        if self._scp_cache is None:
            p = self.scaler.whitening_params()
            self._scp_cache = (self.mesh.replicate(p) if self.mesh is not None
                               else jax.device_put(p))
        return self._scp_cache

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _fetch(self, a):
        """Host numpy copy of a device array that may be sharded over a
        multi-host mesh (non-addressable shards need a process
        all-gather; replicated values convert directly)."""
        if (self.mesh is not None and self.mesh.multihost
                and not getattr(a, "is_fully_replicated", True)):
            return self.mesh.gather(a)
        return np.asarray(jax.device_get(a))

    def _trace(self, name):
        """Phase TraceAnnotation for jax.profiler timelines; a no-op
        context when profiling is off (zero overhead on the hot path)."""
        if self.profile_dir is None:
            from contextlib import nullcontext
            return nullcontext()
        return jax.profiler.TraceAnnotation(name)

    # ------------------------------------------------------------------
    # likelihood evaluation (host-facing)
    # ------------------------------------------------------------------

    def _host_like_raw(self, x):
        """Vectorized host evaluation returning logl only (used in the
        pure_callback path of the device sweep)."""
        logl, _ = self._log_like(np.asarray(x))
        return np.asarray(logl, dtype=np.float64)

    def _log_like(self, x):
        """Full host evaluation with blob extraction (reference
        sampler.py:807-861)."""
        x = np.asarray(x)
        if self.likelihood_traceable:
            logl = np.asarray(jax.device_get(self._loglike_host_jit(jnp.asarray(x))),
                              dtype=np.float64)
            return logl, None
        if self.vectorize:
            return np.asarray(self.log_likelihood(x), dtype=np.float64), None
        if self.pool is not None:
            results = list(self.distribute(self.log_likelihood, x))
        else:
            results = list(map(self.log_likelihood, x))

        try:
            blob = [l[1:] for l in results if hasattr(l, "__len__") and len(l) > 1]
            if not len(blob):
                raise IndexError
            logl = np.array([float(l[0]) for l in results])
            self.have_blobs = True
        except (IndexError, TypeError):
            logl = np.array([float(np.asarray(l).reshape(())) for l in results])
            blob = None
        else:
            if self.blobs_dtype is not None:
                dt = self.blobs_dtype
            else:
                try:
                    dt = np.atleast_1d(blob[0]).dtype
                except ValueError:
                    dt = np.dtype("object")
                if getattr(dt, "kind", "") in "US":
                    dt = np.dtype("object")
            blob = np.array(blob, dtype=dt)
            shape = blob.shape[1:]
            if len(shape):
                axes = np.arange(len(shape))[np.array(shape) == 1] + 1
                if len(axes):
                    blob = np.squeeze(blob, tuple(axes))
        return logl, blob

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    def run(self, n_total: int = 4096, n_evidence: int = 4096,
            progress: bool = True, resume_state_path=None, save_every=None):
        """Run Preconditioned Monte Carlo (reference sampler.py:375-524)."""
        if resume_state_path is not None:
            self.load_state(resume_state_path)
            t0 = self.t
            self.pbar = ProgressBar(self.progress if self.progress is not None else progress,
                                    initial=t0)
            if self.particles.t > 0:
                self.pbar.update_stats(dict(
                    beta=self.particles.get("beta", -1),
                    calls=self.particles.get("calls", -1),
                    ESS=self.particles.get("ess", -1),
                    logZ=self.particles.get("logz", -1)))
        else:
            t0 = self.t
            self.progress = progress
            self.pbar = ProgressBar(progress)
            self.pbar.update_stats(dict(beta=0.0, calls=self.calls,
                                        ESS=self.n_effective, logZ=0.0,
                                        logP=0.0, acc=0.0, steps=0, eff=0.0))

        self.n_total = int(n_total)
        self.n_evidence = int(n_evidence)
        if self._corr_auto or self.bias_rate > 0.0:
            # ladder-grade decorrelation when the SMC persistent-sampling
            # ladder IS the evidence estimator (see __init__ rationale).
            # The engine programs bake corr_threshold into their traces
            # (_engine_key), so a change must re-fetch them — without the
            # rebuild the new target silently never takes effect. The
            # bias_floor (rate-rule spending bound) tracks n_evidence the
            # same way even under an explicit corr_threshold.
            _ct = (self._corr_auto_value(self.n_evidence)
                   if self._corr_auto else self.corr_threshold)
            _bf = self.bias_floor
            if getattr(self, "_bias_floor_auto", True):
                _bf = (self._bias_floor_value(self.n_evidence)
                       if self.bias_rate > 0.0 else 0.0)
            if _ct != self.corr_threshold or _bf != self.bias_floor:
                self.corr_threshold = _ct
                self.bias_floor = _bf
                self._build_device_fns()

        if self.prior_samples is None:
            # Seed the warmup draw from the sampler RNG: an unseeded
            # Prior.rvs pulls OS entropy and breaks random_state
            # reproducibility. Custom priors (duck-typed protocol) may
            # not accept random_state — fall back to their own stream.
            seed = int(self._rng.integers(2**31 - 1))
            try:
                draws = self.sample_prior(self.n_prior, random_state=seed)
            except TypeError:
                # Duck-typed prior whose rvs has no random_state: scope a
                # seeded global np.random state around the call so the
                # draw still repeats under a fixed sampler random_state
                # (the reference seeds np.random globally at __init__,
                # ref sampler.py:195-197; scoping avoids the global
                # side effect while keeping the contract).
                saved = np.random.get_state()
                try:
                    np.random.seed(seed)
                    draws = self.sample_prior(self.n_prior)
                finally:
                    np.random.set_state(saved)
            self.prior_samples = np.asarray(draws, dtype=np.float64)
            self.scaler.fit(self.prior_samples)
            self._scp_cache = None

        if self.profile_dir is not None:
            jax.profiler.start_trace(self.profile_dir)
        try:
            if self.warmup:
                with self._trace("pocomc/warmup"):
                    self._run_warmup(t0, save_every)
                self.warmup = False

            if self._use_device_loop():
                # Per-step live stats during the device loop's sweeps
                # (reference mcmc.py:159-167): on callback-capable
                # backends each sweep step emits through the process-
                # global sink; `calls` shown = last synced total + the
                # running count inside the current sweep (exact up to
                # the pipeline lag).
                if self._live_stats and self.progress:
                    from .mcmc import set_live_sink
                    pbar = self.pbar

                    def _sink(i, cnt, sigma, accept, calls):
                        pbar.update_stats(dict(
                            steps=i, acc=round(accept, 3),
                            calls=self.calls + calls))

                    set_live_sink(_sink)
                try:
                    self._run_device_loop(t0, save_every)
                finally:
                    if self._live_stats and self.progress:
                        set_live_sink(None)
            else:
                while self._not_termination(self.current_particles):
                    if save_every is not None and (self.t - t0) % int(save_every) == 0 and self.t != t0:
                        self.save_state(self.output_dir / f"{self.output_label}_{self.t}.state")

                    with self._trace("pocomc/reweight"):
                        self.current_particles = self._reweight(self.current_particles)
                    with self._trace("pocomc/train"):
                        self.current_particles = self._train(self.current_particles)
                    with self._trace("pocomc/resample"):
                        self.current_particles = self._resample(self.current_particles)
                    with self._trace("pocomc/mutate"):
                        self.current_particles = self._mutate(self.current_particles)
                    self.particles.update(self.current_particles)

            if self.n_evidence > 0 and self.preconditioned:
                with self._trace("pocomc/evidence"):
                    # warnings are deferred until the refinement decision
                    # below: a khat > 0.7 that triggers a refinement round
                    # must not warn (the framework is reacting), but every
                    # OTHER advisory (khat in (0.5, 0.7] under an explicit
                    # method='is', large bootstrap dlogz) must still fire
                    # on runs that never refine
                    self._compute_evidence(self.n_evidence, warn=False)
            else:
                # SMC persistent-sampling evidence with the retroactive
                # per-rung residual re-correction (Particles.
                # recorrected_logz): the causal in-run ladder stays
                # untouched, only the reported estimate is re-laid.
                _, self.logz = self.particles.compute_logw_and_logz(
                    1.0, recorrect=True)
                self.logz_err = None
                # Flow-anchored bridge refinement (bridge.py): replace
                # the ladder read-out with the warped-path estimate when
                # prerequisites hold — a fresh annealed population from
                # the trained flow carries neither the ladder's walker-
                # memory rung bias nor its coverage debt (RESULTS.md
                # round-5 "bridge evidence").
                if self.evidence_bridge in ("auto", True):
                    with self._trace("pocomc/bridge"):
                        res = self._compute_bridge_evidence()
                    if res is not None:
                        self.logz = res["logz"]
                        # per-rung bootstrap error (sampling noise only,
                        # like the flow-IS bar — neither captures flow-
                        # coverage bias)
                        self.logz_err = res.get("logz_err")
                        self.bridge_diagnostics = res
        finally:
            if self.profile_dir is not None:
                jax.profiler.stop_trace()

        if save_every is not None:
            self.save_state(self.output_dir / f"{self.output_label}_final.state")
        self.pbar.close()

        # khat-triggered evidence refinement (see __init__ evidence_refine):
        # k-hat > 0.7 means the preconditioner under-covers the posterior
        # and no amount of n_evidence rescues the flow-IS estimate; the
        # productive reaction is MORE beta=1 history (doubled n_total) —
        # the flow refits on the enriched training set and the evidence
        # is re-drawn. Extending a finished run is the already-supported
        # re-entry path (reference sampler.py:375-524 extends the same
        # way when called again).
        if (self.n_evidence > 0 and self.preconditioned
                and self._refine_round < self.evidence_refine
                and self.evidence_khat is not None
                and self.evidence_khat > 0.7):
            self._refine_round += 1
            try:
                return self.run(n_total=2 * self.n_total,
                                n_evidence=self.n_evidence,
                                progress=progress, save_every=save_every)
            finally:
                self._refine_round -= 1

        # no refinement happened (khat fine, or rounds spent): emit the
        # deferred evidence-quality advisories now
        if self.n_evidence > 0 and self.preconditioned:
            self._warn_evidence_quality(self.logz_err, self.evidence_khat,
                                        self.evidence_method)

    def _run_warmup(self, t0, save_every):
        # traceable path: ONE device program for the whole prior stage
        # (scaler forward/inverse + prior + likelihood on all n_prior
        # rows) instead of ~6 dispatches per batch
        pre = None
        if self._use_device_loop():
            prog = self._prog_cache.get(("WU",))
            if prog is None:
                scaler, log_prior = self.scaler, self._logprior_dev
                like = self._like_batch_fn

                like32 = f32_precision(like)

                def wu(x, scp):
                    u = scaler.forward(x, params=scp)
                    _, logdetj = scaler.inverse(u, params=scp)
                    return u, logdetj, log_prior(x), like32(x)

                prog = self._prog_cache[("WU",)] = jax.jit(wu)
            xs = np.asarray(self.prior_samples, dtype=np.float32)
            xs = (self.mesh.shard_particles(xs) if self.mesh is not None
                  else jnp.asarray(xs))
            pre = [np.asarray(self._fetch(a), dtype=np.float64)
                   for a in prog(xs, self._scp())]

        # resuming from a mid-warmup checkpoint: batches already stored in
        # the history must not be replayed (slots would duplicate and the
        # multiple-IS denominator would double-count their beta=0 terms)
        start_batch = self.particles.t
        for i in range(start_batch, self.n_prior // self.n_active):
            if save_every is not None and (self.t - t0) % int(save_every) == 0 and self.t != t0:
                self.save_state(self.output_dir / f"{self.output_label}_{self.t}.state")
            sl = slice(i * self.n_active, (i + 1) * self.n_active)
            x = self.prior_samples[sl]
            if pre is not None:
                u, logdetj, logp, logl = (a[sl].copy() for a in pre)
                blobs = None
            else:
                to_dev = (self.mesh.shard_particles
                          if self.mesh is not None else jnp.asarray)
                u = np.asarray(self._fetch(self._scaler_forward(
                    to_dev(np.asarray(x, dtype=np.float32)), self._scp())),
                    dtype=np.float64)
                _, logdetj_d = self._scaler_inverse(
                    to_dev(np.asarray(u, dtype=np.float32)), self._scp())
                logdetj = np.asarray(self._fetch(logdetj_d),
                                     dtype=np.float64)
                logp = np.asarray(jax.device_get(jnp.asarray(self._logprior_host(jnp.asarray(x, dtype=jnp.float32)))), dtype=np.float64)
                logl, blobs = self._log_like(x)
            self.calls += self.n_active

            # replace infinite-likelihood particles by finite ones
            inf_mask = np.isinf(logl)
            if np.any(inf_mask):
                all_idx = np.arange(len(x))
                finite_idx = all_idx[~inf_mask]
                if len(finite_idx) == 0:
                    raise RuntimeError("All prior-stage likelihoods are non-finite.")
                repl = self._rng.choice(finite_idx, size=int(inf_mask.sum()), replace=True)
                x = x.copy(); u = u.copy()
                x[inf_mask] = x[repl]
                u[inf_mask] = u[repl]
                logdetj[inf_mask] = logdetj[repl]
                logp[inf_mask] = logp[repl]
                logl[inf_mask] = logl[repl]
                if self.have_blobs and blobs is not None:
                    blobs[inf_mask] = blobs[repl]

            self.current_particles = dict(
                u=u, x=x, logl=logl, logp=logp, logdetj=logdetj,
                logw=-1e300 * np.ones(self.n_active), blobs=blobs,
                iter=self.t, calls=self.calls, steps=1, efficiency=1.0,
                ess=self.n_effective, accept=1.0, beta=0.0, logz=0.0,
                resid=0.0, hot=0.0)
            self.particles.update(self.current_particles)
            self.pbar.update_stats(dict(calls=self.calls, beta=0.0,
                                        ESS=int(self.n_effective), logZ=0.0,
                                        logP=float(np.mean(logp + logl))))
            self.pbar.update_iter()
            self.t += 1

    # ------------------------------------------------------------------
    # device-resident SMC loop (parallel/fused.py)
    # ------------------------------------------------------------------

    def _use_device_loop(self):
        """The device loop runs when everything in the iteration traces
        (likelihood, prior, flow) and the host-only features are off.
        Each iteration is then 3 dispatches + 1 blocking sync instead of
        the host path's ~20 device interactions."""
        if self.device_loop is False or not self._device_loop_ok or self.have_blobs:
            return False
        cfg = self.train_config
        if self.preconditioned and (cfg["annealing"] or cfg["noise"] is not None):
            return False  # host fit handles these
        return True

    def _seed32(self):
        return np.uint32(self._rng.integers(2**31 - 1))

    def _select_bucket(self, t_max):
        """Static top-K training/geometry-set size: pow2 bucket of 4x the
        run's maximum effective support. The history ESS reaches n_total
        at termination (reference keeps the whole trimmed set,
        sampler.py:792-799) — a fixed multiple of n_effective truncates
        the late-run training set and degrades the flow (measured: logZ
        bias -0.45 on the quickstart). One K for the whole run keeps the
        reweight/train/mutate programs at a single trace+compile per
        process (first-call compile costs dominate short runs); rows
        beyond the trim survivors carry zero weight
        and are invisible to the weighted losses. Grows only if dynamic
        n_effective exceeds it. Clipped to the flat history size."""
        k = max(4 * self.n_effective, 4 * int(self.n_total), self.n_active)
        k = 1 << int(math.ceil(math.log2(k)))
        return int(min(k, t_max * self.n_active))

    def _device_programs(self, n_select):
        from .parallel import fused
        keyA = ("A", n_select)
        if keyA not in self._prog_cache:
            self._prog_cache[keyA] = fused.make_reweight_program(
                n_select, self.n_active, metric=self.metric,
                dynamic=self.dynamic, dynamic_ratio=self.dynamic_ratio,
                bias_budget=self.bias_budget)
        keyC = ("C",)
        if keyC not in self._prog_cache:
            sweep = (self._sweep_precond if self.preconditioned
                     else self._sweep_plain)
            self._prog_cache[keyC] = fused.make_mutate_program(
                sweep.raw, self.n_active, resample=self.resample,
                metric=self.metric, preconditioned=self.preconditioned)
        progB = None
        if self.preconditioned:
            cfg = self.train_config
            bs = int(min(n_select // 2, cfg["batch_size"]))
            keyB = ("B", n_select, bs, cfg["validation_split"],
                    cfg["epochs"], cfg["patience"], cfg["learning_rate"],
                    cfg["clip_grad_norm"], cfg["laplace_scale"],
                    cfg["gaussian_scale"])
            if keyB not in self._prog_cache:
                self._prog_cache[keyB] = fused.make_train_program(
                    self.flow, n_select, bs,
                    validation_split=cfg["validation_split"],
                    epochs=cfg["epochs"], patience=cfg["patience"],
                    learning_rate=cfg["learning_rate"],
                    clip_grad_norm=cfg["clip_grad_norm"],
                    laplace_scale=cfg["laplace_scale"],
                    gaussian_scale=cfg["gaussian_scale"])
            progB = self._prog_cache[keyB]
        return self._prog_cache[keyA], progB, self._prog_cache[keyC]

    def _geom_from_host(self):
        """Rebuild the device geometry dict from the host Geometry mirror
        (resume path)."""
        g = self.theta_geometry if self.preconditioned else self.u_geometry
        if g.t_mean is None:
            return None
        return {k: jnp.asarray(v) for k, v in vars(g).items()
                if v is not None}

    def _run_device_loop(self, t0, save_every):
        from .parallel import fused
        d = self.n_dim

        t_cur = self.particles.t
        t_max = 1 << int(math.ceil(math.log2(max(t_cur + 48, 64))))
        hist = fused.history_from_numpy(
            self.particles.get("u"), self.particles.get("x"),
            self.particles.get("logdetj"), self.particles.get("logl"),
            self.particles.get("logp"),
            self.particles.get("beta"), self.particles.get("logz"), t_max)
        if self.mesh is not None:
            # multi-host safe placement (ParticleMesh._put): particle
            # axis sharded, slot scalars replicated on every process
            hist = self.mesh.shard_history(hist)
        self._hist_dev = hist
        self._slot_count = t_cur
        self._synced_slots = t_cur
        self._dev_iter_stats = []

        if self.preconditioned and self._geom_dev is None:
            self._geom_dev = self._geom_from_host()
        if self.mesh is not None:
            # device-loop inputs must live on the global mesh (jit may
            # not mix process-local and global arrays on multi-host)
            if self.preconditioned:
                self.flow.params = self.mesh.replicate(self.flow.params)
            if self._geom_dev is not None:
                self._geom_dev = self.mesh.replicate(self._geom_dev)

        # loop-entry state from the host history (f64)
        beta_h = float(self.particles.get("beta", index=-1))
        logw, _ = self.particles.compute_logw_and_logz(1.0)
        w = np.exp(logw - np.max(logw))
        ess1_h = (effective_sample_size(w) if self.metric == "ess"
                  else unique_sample_size(w))
        ess_h = ess1_h if beta_h >= 1.0 else float(self.n_effective)
        # per-iteration (wall, steps, n_select) diagnostics: written for
        # post-hoc inspection (perf forensics scripts read it); not
        # consumed by the run itself
        self._iter_walls = []

        import time as _time
        # Pipelined execution: the three phase enqueues are cheap while
        # the blocking per-iteration stats sync waits for the device. So
        # iteration t+1 is enqueued BEFORE iteration t's stats are
        # synced: the device computes t+1 while t's sync is in flight.
        # All device-side state (history, flow
        # params, geometry, beta ladder) chains by reference and stays
        # exact; only the HOST decisions (termination, train cadence,
        # sigma0 carry-over, dynamic n_effective, bucket size) run
        # `pipeline` iterations behind — each is an adaptation input
        # that tolerates the lag (the beta==1 forced retrain was already
        # documented as one-late; termination overshoots by at most
        # `pipeline` iterations whose samples are KEPT — they are
        # ordinary SMC iterations at the final temperature).
        pending = []
        terminated = not (1.0 - beta_h >= 1e-4 or ess1_h < self.n_total)
        # residual-hotness of the newest history stage (ladder correction
        # input to phase A); a resumed run re-seeds it from the host store
        self._resid_dev = jnp.float32(
            self.particles.get("resid", index=-1)
            if self.particles.past.get("resid") else 0.0)
        # Adaptation scalars chained DEVICE-TO-DEVICE, like _resid_dev:
        # the sweep's exit proposal scale feeds the next sweep and phase
        # A's dynamic n_effective feeds the next phase A directly from
        # the previous iteration's (possibly unsynced) device outputs.
        # Routing them through the host sync made each iteration's
        # inputs stale by up to 2*pipeline iterations — the reason depth
        # > 1 measured SLOWER (a stale sigma forces the next sweep to
        # re-adapt, and adaptation steps are likelihood calls). With the
        # chain, the blocking stats sync is pure reporting and its
        # cadence cannot perturb the trajectory; host mirrors
        # (proposal_scale, n_effective) update at sync for checkpoints /
        # diagnostics only.
        self._sigma_dev = jnp.float32(self.proposal_scale)
        self._neff_dev = jnp.float32(self.n_effective)

        def sync_batch(k):
            """Sync the oldest k pending iterations in ONE device_get (one
            host wait amortizes over k iterations)."""
            nonlocal beta_h, ess1_h, ess_h, terminated
            batch = pending[:k]
            del pending[:k]
            try:
                # ONE batched transfer for the whole drain window: the
                # sync amortizes over k iterations (the point of the
                # pipeline), and each iteration's statsA/statsC ride in
                # a single packed device vector (one fetched buffer per
                # iteration instead of two). Stats vectors are
                # replicated jit outputs, so this works multi-host.
                stats = jax.device_get(
                    [(p["stats"], p["tstats"]) for p in batch])
            except Exception:
                # a backend/sharding combination where the outputs came
                # back non-replicated: per-array all-gather fallback
                stats = [(self._fetch(p["stats"]),
                          None if p["tstats"] is None
                          else self._fetch(p["tstats"])) for p in batch]
            nA = fused.STATS_A_LEN
            for p, (packed, tstats) in zip(batch, stats):
                statsA, statsC = packed[:nA], packed[nA:]
                if statsC[6] > 0.5:
                    # device-side termination guard fired: the iteration
                    # was a no-op (no sweep, no calls, no history slot) —
                    # roll back its optimistic host-side accounting
                    self.t -= 1
                    self._slot_count -= 1
                    continue
                beta_h = float(statsA[0])
                logz_h = float(statsA[1])
                ess_h = float(statsA[2])
                if self.dynamic:
                    self.n_effective = int(statsA[3])
                accept = float(statsC[0])
                steps = int(statsC[1])
                self.calls += int(statsC[2])
                self.proposal_scale = float(statsC[3])
                ess1_h = float(statsC[4])
                logp_mean = float(statsC[5])
                eff = self.proposal_scale / (2.38 / math.sqrt(d))
                self._dev_iter_stats.append(dict(
                    iter=p["t"], calls=self.calls, steps=steps,
                    efficiency=eff, ess=ess_h, accept=accept, beta=beta_h,
                    logz=logz_h,
                    corr=float(statsC[7]) if len(statsC) > 7 else None,
                    resid=float(statsC[8]) if len(statsC) > 8 else 0.0,
                    hot=float(statsC[9]) if len(statsC) > 9 else 0.0,
                    z_logl=float(statsC[10]) if len(statsC) > 10 else 0.0,
                    z_dim=float(statsC[11]) if len(statsC) > 11 else 0.0,
                    nu=float(statsC[12]) if len(statsC) > 12 else 0.0,
                    misfit=float(statsC[13]) if len(statsC) > 13 else 0.0,
                    resid_exit=(float(statsC[14])
                                if len(statsC) > 14 else 0.0),
                    # flow-fit observability (round-5 cosmo30 seed-1
                    # forensics): epochs run + best validation loss of
                    # the iteration's fit, None when no fit ran
                    train_epochs=(None if tstats is None
                                  else int(tstats[0])),
                    train_loss=(None if tstats is None
                                else float(tstats[1])),
                    sigma=self.proposal_scale))
                self.pbar.update_stats(dict(
                    beta=beta_h, calls=self.calls, ESS=int(ess_h),
                    logZ=logz_h, logP=logp_mean, acc=accept, steps=steps,
                    eff=eff))
                self._iter_walls.append(
                    (_time.perf_counter() - p["t_start"], steps,
                     p["n_select"]))
            terminated = not (1.0 - beta_h >= 1e-4 or ess1_h < self.n_total)

        while not (terminated and not pending):
            if not terminated:
                _t_iter = _time.perf_counter()
                if (save_every is not None
                        and (self.t - t0) % int(save_every) == 0
                        and self.t != t0):
                    if pending:   # stats must align with synced slots
                        sync_batch(len(pending))
                    self._sync_device_history()
                    self.save_state(
                        self.output_dir / f"{self.output_label}_{self.t}.state")
                    if terminated:
                        continue

                if self._slot_count >= t_max:
                    t_max *= 2
                    hist = fused.grow_history(hist, t_max)

                n_select = self._select_bucket(t_max)
                progA, progB, progC = self._device_programs(n_select)

                self.t += 1
                self.pbar.update_iter()
                # training cadence (reference sampler.py:648-652); beta_h
                # is the last SYNCED beta (see pipeline note above)
                train_now = self.preconditioned and (
                    self.t % self.train_frequency == 0 or beta_h >= 1.0
                    or self.flow_untrained)

                with self._trace("pocomc/reweight"):
                    # resid_prev / n_effective ride device-to-device from
                    # the previous iteration's (possibly not-yet-synced)
                    # outputs — the pipeline never blocks on them
                    outA = progA(hist, self._neff_dev,
                                 jnp.float32(self.n_total),
                                 self._resid_dev)
                self._neff_dev = outA["stats"][3]
                _tstats = None   # [n_done, best_loss] when a fit ran
                if train_now:
                    with self._trace("pocomc/train"):
                        params, geom, _tstats = progB(
                            self.flow.params, outA["u_sel"], outA["w_sel"],
                            self._seed32(), outA["terminated"])
                    self.flow.params = params
                    self._geom_dev = geom
                    self.flow_untrained = False
                flow_params = self.flow.params if self.preconditioned else None
                with self._trace("pocomc/mutate"):
                    hist, packed = progC(hist, outA["beta"], outA["logz"],
                                         outA["w_flat"], outA["u_sel"],
                                         outA["w_sel"],
                                         self._sigma_dev,
                                         self._geom_dev, flow_params,
                                         self._seed32(), self._scp(),
                                         outA["terminated"],
                                         outA["stats"])
                self._sigma_dev = packed[fused.STATS_A_LEN + 3]
                self._hist_dev = hist
                # UNCONDITIONAL: gating this on the exit hot flag was
                # measured and rejected (RESULTS.md round 3 "hot-gating
                # postmortem") — sub-threshold exit resid carries real
                # residual relaxation, not just noise (funnel25 flow-IS
                # −0.25 ungated vs −0.96 gated; quickstart calls
                # 57.3k vs 59.9k).
                self._resid_dev = packed[fused.STATS_A_LEN + 8]
                self._slot_count += 1
                pending.append(dict(stats=packed, tstats=_tstats, t=self.t,
                                    n_select=n_select, t_start=_t_iter))

            if pending and terminated:
                sync_batch(len(pending))
            elif self.pipeline == 0 and pending:
                sync_batch(1)
            elif self.pipeline > 0 and len(pending) >= 2 * self.pipeline:
                # drain half the window in one round trip: at depth K the
                # sync RTT amortizes over K iterations
                sync_batch(self.pipeline)

        self._sync_device_history()

    def _sync_device_history(self):
        """Pull un-synced device history slots into the host Particles
        store (one batched transfer) so posterior()/results/checkpoints
        see the same history as the host path."""
        hist = self._hist_dev
        if hist is None:
            return
        k0, k1 = self._synced_slots, self._slot_count
        if k1 > k0:
            if self.mesh is not None and self.mesh.multihost:
                # non-addressable shards: all-gather the full buffers on
                # every process, slice on host (ParticleMesh.gather)
                u, x, logdetj, logl, logp = (
                    self.mesh.gather(a)[k0:k1]
                    for a in (hist.u, hist.x, hist.logdetj, hist.logl,
                              hist.logp))
            else:
                u, x, logdetj, logl, logp = jax.device_get(
                    (hist.u[k0:k1], hist.x[k0:k1], hist.logdetj[k0:k1],
                     hist.logl[k0:k1], hist.logp[k0:k1]))
            stats = self._dev_iter_stats[-(k1 - k0):]
            last = None
            for i, st in enumerate(stats):
                last = dict(
                    u=np.asarray(u[i], np.float64),
                    x=np.asarray(x[i], np.float64),
                    logdetj=np.asarray(logdetj[i], np.float64),
                    logl=np.asarray(logl[i], np.float64),
                    logp=np.asarray(logp[i], np.float64), **st)
                self.particles.update(last)
            self.particles.results_dict = None
            self._synced_slots = k1
            self.current_particles = last
        if self._geom_dev is not None:
            tgt = (self.theta_geometry if self.preconditioned
                   else self.u_geometry)
            for key, val in self._geom_dev.items():
                setattr(tgt, key, val)

    # ------------------------------------------------------------------
    # SMC phases
    # ------------------------------------------------------------------

    def _not_termination(self, current_particles):
        logw, _ = self.particles.compute_logw_and_logz(1.0)
        w = np.exp(logw - np.max(logw))
        ess = (effective_sample_size(w) if self.metric == "ess"
               else unique_sample_size(w))
        return 1.0 - current_particles.get("beta") >= 1e-4 or ess < self.n_total

    def _reweight(self, current_particles):
        self.t += 1
        self.pbar.update_iter()

        beta_hist = self.particles.get("beta")
        logz_hist = self.particles.get("logz")
        beta_prev = self.particles.get("beta", index=-1)
        # Incrementally maintained mixture denominator (O(T*n) per
        # iteration; see Particles.mis_denominator) — bisect_beta skips
        # its own O(T^2 * n) build.
        B, logl_hist = self.particles.mis_denominator()

        beta, logw, ess_est, logz = bisect_beta(
            logl_hist, beta_hist, logz_hist, beta_prev,
            self.n_effective, metric=self.metric, B_flat=B.reshape(-1))
        if self.bias_budget > 0.0 and beta > beta_prev:
            # Coverage-targeted beta spacing (host mirror of the fused
            # reweight cap, parallel/fused.py): each rung inherits at
            # most bias_budget nats of estimated source-population
            # hotness; with the 2^-8 progress floor the ladder stays
            # bounded even if resid never shrinks.
            resid_prev = (self.particles.get("resid", index=-1)
                          if self.particles.past.get("resid") else 0.0)
            adv = max(self.bias_budget / max(abs(resid_prev), 1e-12),
                      2.0 ** -8)
            if beta - beta_prev > adv:
                beta = beta_prev + adv
                logw, logz = logw_from_mis_denominator(
                    logl_hist.reshape(-1), B.reshape(-1), beta)
                w_cap = np.exp(logw - np.max(logw))
                w_cap /= w_cap.sum()
                ess_est = (effective_sample_size(w_cap)
                           if self.metric == "ess"
                           else unique_sample_size(w_cap))
        if beta == beta_prev:
            logz = self.particles.get("logz", index=-1)
        elif self.calib_z > 0.0:
            # Residual-hotness ladder correction: the rung estimate is
            # dominated by the latest stage's population, which is hot by
            # ~(-resid) nats (resid = extrapolated REMAINING mean-logl
            # drift, mcmc.py accept_update — negative while a selection-
            # hot population still relaxes downward). Since dlogZ/dbeta =
            # E_beta[logl], the rung inherits dbeta * hotness of upward
            # bias — measured on the 50-D cond-1e3 Gaussian (closed-form
            # tempered logz at every rung): drift = sum(dbeta*hot) to 4%,
            # RESULTS.md round 3. Subtracting dbeta * hotness = ADDING
            # dbeta * resid (sign verified per stage against the gauss50
            # oracle, benchmarks/smc_evidence_gauss50.py) removes
            # whatever bias the adaptive mutation budget could not afford
            # to sweep away. The corrected value is STORED, so later
            # rungs, MIS weights, and beta selection stay self-consistent
            # (the oracle-ladder experiment shows correct rungs make the
            # final MIS estimate exact). UNCONDITIONAL: hot-gating was
            # measured and rejected (RESULTS.md "hot-gating postmortem").
            logz += (beta - beta_prev) * self.particles.get(
                "resid", index=-1)
        self.pbar.update_stats(dict(beta=beta, ESS=int(ess_est), logZ=logz))

        weights = np.exp(logw - np.max(logw))
        weights /= weights.sum()

        if self.dynamic:
            n_unique_active = unique_sample_size(weights, k=self.n_active)
            if n_unique_active < self.n_active * (0.95 * self.dynamic_ratio):
                self.n_effective = int(self.n_active / n_unique_active * self.n_effective)
            elif n_unique_active > self.n_active * min(1.05 * self.dynamic_ratio, 1.0):
                self.n_effective = int(n_unique_active / self.n_active * self.n_effective)

        mask, weights_t = trim_weights(weights, ess=0.99, bins=1000)
        idx = np.nonzero(mask)[0]
        current_particles["u"] = self.particles.get("u", flat=True)[idx]
        current_particles["x"] = self.particles.get("x", flat=True)[idx]
        current_particles["logdetj"] = self.particles.get("logdetj", flat=True)[idx]
        current_particles["logl"] = self.particles.get("logl", flat=True)[idx]
        current_particles["logp"] = self.particles.get("logp", flat=True)[idx]
        if self.have_blobs:
            current_particles["blobs"] = self.particles.get("blobs", flat=True)[idx]
        current_particles["logz"] = logz
        current_particles["beta"] = beta
        current_particles["weights"] = weights_t
        current_particles["ess"] = ess_est
        return current_particles

    @staticmethod
    def _pad_pow2(u, w, rng):
        """Pad (u, w) to a power-of-two row count with zero-weight
        duplicate rows: keeps flow-forward/geometry-fit compile shapes
        bucketed as the trimmed history drifts, without touching any
        weighted statistic."""
        n = len(u)
        n_bucket = 1 << (n - 1).bit_length()
        if n_bucket == n:
            return u, w
        idx = rng.integers(0, n, size=n_bucket - n)
        return (np.concatenate([u, u[idx]], axis=0),
                np.concatenate([w, np.zeros(n_bucket - n, dtype=w.dtype)]))

    def _run_stepped_sweep(self, sweep, args, flow_params, blobs,
                           dbeta=0.0):
        """Host-driven MCMC sweep: the likelihood (and blobs) are evaluated
        on host between the jitted propose/accept halves. Used when blobs
        must be tracked through every accept/reject (reference mcmc.py:113-149 semantics)."""
        u, x, logdetj, logl, logp, beta, sigma0, geom, key = args
        st = sweep.init_state(u, x, logdetj, logl, logp, beta, sigma0, geom,
                              flow_params=flow_params, key=key,
                              dbeta=jnp.float32(dbeta))
        n = self.n_active
        if blobs is not None:
            blobs = blobs.copy()
        calls = 0
        # Two round trips per step instead of three: the previous step's
        # packed [i, cnt, sigma, mean_alpha, corr] stats ride in the SAME
        # transfer as the next step's proposal (their device values exist
        # by then), and the continue/stop decision happens BEFORE that
        # proposal's likelihood is evaluated — a stop discards only the
        # speculative device-side proposal, never a likelihood batch.
        prop = sweep.propose(st, beta, geom, flow_params, self._scp())
        pending_stats = None
        while True:
            if pending_stats is None:
                finite, x_safe = jax.device_get(
                    (prop["finite"], prop["x_safe"]))
            else:
                finite, x_safe, stats = jax.device_get(
                    (prop["finite"], prop["x_safe"], pending_stats))
                stats = np.asarray(stats, dtype=np.float64)
                i, cnt, sigma = int(stats[0]), int(stats[1]), float(stats[2])
                if self.pbar is not None:
                    # reference shows these live per step (mcmc.py:159-167)
                    self.pbar.update_stats(dict(
                        calls=self.calls + calls, acc=float(stats[3]),
                        steps=i))
                if not sweep.should_continue(
                        i, cnt, sigma, corr=float(stats[4]),
                        hot=float(stats[5]) if len(stats) > 5 else 0.0,
                        resid=float(stats[6]) if len(stats) > 6 else 0.0,
                        dbeta=dbeta,
                        var_logl=float(stats[7]) if len(stats) > 7 else 0.0):
                    break
            finite = np.asarray(finite)
            logl_p = np.full(n, -np.inf)
            blobs_p = None
            if finite.any():
                x_masked = np.asarray(x_safe, dtype=np.float64)[finite]
                ll, bl = self._log_like(x_masked)
                logl_p[finite] = ll
                if self.have_blobs and bl is not None:
                    if blobs is None:
                        blobs = np.empty(n, dtype=bl.dtype)
                        blobs[:] = bl[0]
                    blobs_p = blobs.copy()
                    blobs_p[finite] = bl
            calls += int(finite.sum())
            st, accept, stats = sweep.accept_update(
                st, prop, jnp.asarray(logl_p, dtype=jnp.float32), beta, geom)
            if blobs_p is not None:
                acc = np.asarray(jax.device_get(accept))
                blobs[acc] = blobs_p[acc]
            pending_stats = stats
            prop = sweep.propose(st, beta, geom, flow_params, self._scp())
        results = sweep.results(st)
        results = dict(results)
        results["calls"] = calls
        return results, blobs

    def _train(self, current_particles):
        u = current_particles["u"]
        w = current_particles["weights"]
        u, w = self._pad_pow2(np.asarray(u), np.asarray(w, dtype=np.float64),
                              self._rng)
        if self.preconditioned and (self.t % self.train_frequency == 0
                                    or current_particles["beta"] == 1.0
                                    or self.flow_untrained):
            self.flow_untrained = False
            cfg = self.train_config
            self.flow.fit(np.asarray(u, dtype=np.float32),
                          weights=np.asarray(w, dtype=np.float32),
                          validation_split=cfg["validation_split"],
                          epochs=cfg["epochs"],
                          batch_size=int(min(len(u) // 2, cfg["batch_size"])),
                          gaussian_scale=cfg["gaussian_scale"],
                          laplace_scale=cfg["laplace_scale"],
                          patience=cfg["patience"],
                          learning_rate=cfg["learning_rate"],
                          annealing=cfg["annealing"],
                          noise=cfg["noise"],
                          shuffle=cfg["shuffle"],
                          clip_grad_norm=cfg["clip_grad_norm"],
                          verbose=cfg["verbose"],
                          seed=int(self._rng.integers(2**31 - 1)),
                          mesh=self.mesh)
            to_dev = (self.mesh.shard_particles
                      if self.mesh is not None else jnp.asarray)
            theta, _ = self.flow.forward(to_dev(np.asarray(u, np.float32)))
            self.theta_geometry.fit(theta,
                                    weights=to_dev(np.asarray(w, np.float32)),
                                    key=self._next_key())
        elif not self.preconditioned:
            # reference fits u_geometry every non-training iteration even
            # when preconditioned (sampler.py:674), but the preconditioned
            # kernels only ever read theta_geometry — skipping the unused
            # Student-t EM saves a device program + sync per iteration
            to_dev = (self.mesh.shard_particles
                      if self.mesh is not None else jnp.asarray)
            self.u_geometry.fit(to_dev(np.asarray(u, np.float32)),
                                weights=to_dev(np.asarray(w, np.float32)),
                                key=self._next_key())
        return current_particles

    def _resample(self, current_particles):
        w = current_particles["weights"]
        if self.resample == "mult":
            idx = multinomial_resample(self.n_active, w, self._rng)
        else:
            idx = systematic_resample(self.n_active, w, self._rng)
        for key in ("u", "x", "logdetj", "logl", "logp"):
            current_particles[key] = current_particles[key][idx]
        if self.have_blobs:
            current_particles["blobs"] = current_particles["blobs"][idx]
        return current_particles

    def _mutate(self, current_particles):
        geom_src = self.theta_geometry if self.preconditioned else self.u_geometry
        geom = dict(t_mean=geom_src.t_mean, t_chol=geom_src.t_chol,
                    t_inv_cov=geom_src.t_inv_cov, t_nu=geom_src.t_nu,
                    normal_chol=geom_src.normal_chol)

        f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
        if self.mesh is not None:
            shard = lambda a: self.mesh.shard_particles(f32(a))
            geom = self.mesh.replicate(geom)
            flow_params = (self.mesh.replicate(self.flow.params)
                           if self.preconditioned else None)
        else:
            shard = f32
            flow_params = self.flow.params
        args = (shard(current_particles["u"]), shard(current_particles["x"]),
                shard(current_particles["logdetj"]), shard(current_particles["logl"]),
                shard(current_particles["logp"]),
                jnp.float32(current_particles["beta"]),
                jnp.float32(self.proposal_scale), geom, self._next_key())
        # current rung size (yardstick for the sweep's bias-budget
        # stopping rule, mcmc.py `cond`); the new rung is not in the
        # history store yet, so past[-1] is the previous stage
        dbeta = max(float(current_particles["beta"])
                    - float(self.particles.get("beta", index=-1)), 0.0)
        sweep = self._sweep_precond if self.preconditioned else self._sweep_plain
        stepped = self._sweep_mode == "stepped" or self.have_blobs
        if stepped:
            results, blobs = self._run_stepped_sweep(
                sweep, args, flow_params, current_particles.get("blobs"),
                dbeta=dbeta)
            results = jax.device_get(results)
        else:
            if self._live_stats and self.progress:
                from .mcmc import set_live_sink
                pbar, calls0 = self.pbar, self.calls
                set_live_sink(lambda i, cnt, sigma, accept, calls:
                              pbar.update_stats(dict(
                                  steps=i, acc=round(accept, 3),
                                  calls=calls0 + calls)))
            try:
                if self.preconditioned:
                    results = sweep(*args, flow_params=flow_params,
                                    scaler_params=self._scp(),
                                    dbeta=jnp.float32(dbeta))
                else:
                    results = sweep(*args, scaler_params=self._scp(),
                                    dbeta=jnp.float32(dbeta))
                # device_get blocks: all pending live-stat callbacks have
                # fired before the sink is torn down
                if self.mesh is not None and self.mesh.multihost:
                    # particle arrays come back mesh-sharded (non-
                    # addressable): all-gather each; scalars convert
                    results = {k: self._fetch(v)
                               for k, v in results.items()}
                else:
                    results = jax.device_get(results)
            finally:
                if self._live_stats and self.progress:
                    set_live_sink(None)

        for key in ("u", "x", "logdetj", "logl", "logp"):
            current_particles[key] = np.asarray(results[key], dtype=np.float64)
        current_particles["efficiency"] = float(results["efficiency"]) / (2.38 / math.sqrt(self.n_dim))
        current_particles["steps"] = int(results["steps"])
        current_particles["accept"] = float(results["accept"])
        current_particles["calls"] = self.calls + int(results["calls"])
        current_particles["iter"] = self.t
        # residual-hotness estimate for the evidence-ladder bias
        # correction (mcmc.py accept_update, ops/weights.py) + the exit
        # hot flag (stored diagnostic only — gating the correction on it
        # was measured and rejected, RESULTS.md "hot-gating postmortem")
        current_particles["resid"] = float(results.get("resid", 0.0))
        current_particles["resid_exit"] = float(
            results.get("resid_exit", 0.0))
        current_particles["hot"] = float(results.get("hot", 0.0))
        current_particles["corr"] = float(results.get("corr", 0.0))
        self.calls = current_particles["calls"]
        self.proposal_scale = float(results["proposal_scale"])

        if self.have_blobs and stepped:
            current_particles["blobs"] = blobs

        self.pbar.update_stats(dict(
            calls=self.calls, acc=current_particles["accept"],
            steps=current_particles["steps"],
            logP=float(np.mean(current_particles["logl"] + current_particles["logp"])),
            eff=current_particles["efficiency"]))
        return current_particles

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def evidence(self):
        """(logz, logz_err). With n_evidence>0 this is the flow-IS
        estimate + bootstrap error. With n_evidence=0 and the bridge
        active (evidence_bridge, the default when preconditioned +
        traceable) it is the flow-anchored bridge estimate + its
        per-rung bootstrap error. logz_err is None only on the raw
        ladder fallback (evidence_bridge=False / black-box likelihood /
        precondition=False) — reference behavior there (sampler.py:
        863-867, logz_err unset outside _compute_evidence)."""
        return self.logz, self.logz_err

    def _resolve_evidence_proposal(self):
        """'auto' -> 't' when the flow exposes the t-latent sampler (all
        built-in flows; models/flow.py sample_t), else 'flow'. An
        explicit 't' on a custom flow without the sampler is an error."""
        if self.evidence_proposal == "flow":
            return "flow"
        if hasattr(self.flow, "_sample_t"):
            return "t"
        if self.evidence_proposal == "t":
            raise ValueError(
                "evidence_proposal='t' requires the flow to expose a "
                "_sample_t(params, key, size, nu) t-latent sampler (all "
                "built-in flows do; see docs/flows.md for the custom-flow "
                "protocol). Use evidence_proposal='flow' or 'auto'.")
        return "flow"

    def _evidence_program(self, n):
        """Fused flow-IS ratio computation: sample + scaler + prior +
        likelihood as ONE device program (traceable path).  Returns the
        raw log-ratio vector (-inf on rows the prior rejects); the
        estimator itself runs on host f64 (see _compute_evidence) so the
        plain-IS and PSIS paths share one program."""
        proposal = self._resolve_evidence_proposal()
        self.evidence_proposal_used = proposal
        key = (("EVW", n) if proposal == "flow"
               else ("EVW", n, "t", self.evidence_nu))
        if key not in self._prog_cache:
            scaler, log_prior = self.scaler, self._logprior_dev
            like = self._like_batch_fn
            flow = self.flow
            nu = self.evidence_nu

            def ev(params, seed, scp):
                k_s = jax.random.key(seed)
                if proposal == "t":
                    u_q, logq = flow._sample_t(params, k_s, n, nu)
                else:
                    u_q, logq = flow._sample(params, k_s, n)
                x_q, logdetj = scaler.inverse(u_q, params=scp)
                logp = log_prior(x_q)
                finite = jnp.isfinite(logp)
                x_safe = jnp.where(finite[:, None], x_q, 0.0)
                logl = jnp.where(finite, f32_precision(like)(x_safe),
                                 -jnp.inf)
                # prior-rejected draws -> NaN (dropped from the average,
                # reference sampler.py:897-901); -inf-LIKELIHOOD draws
                # keep their -inf logw and stay in the denominator
                # (reference keeps them in len(logw) at :910)
                return jnp.where(finite, logl + logp + logdetj - logq,
                                 jnp.nan)

            self._prog_cache[key] = jax.jit(ev)
        return self._prog_cache[key]

    def _compute_evidence(self, n=5_000, warn=True):
        """Flow importance-sampling evidence + bootstrap error
        (reference sampler.py:869-920), hardened with the PSIS k-hat tail
        diagnostic and an optional Pareto-smoothed estimator
        (ops/psis.py; Vehtari et al. 2024)."""
        if self._use_device_loop():
            logw = np.asarray(self._fetch(
                self._evidence_program(n)(self.flow.params, self._seed32(),
                                          self._scp())), dtype=np.float64)
            # drop NaN (prior-rejected: reference parity, sampler.py:
            # 897-901 removes them from the average too) and any
            # pathological +inf overflow row (would poison logz/k-hat);
            # KEEP -inf-likelihood rows in the denominator
            logw = logw[~(np.isnan(logw) | np.isposinf(logw))]
        else:
            proposal = self._resolve_evidence_proposal()
            if proposal == "t" and not hasattr(self.flow, "_sample"):
                # custom flow with _sample_t but no _sample: the host
                # driver below can only draw through flow.sample
                # (Gaussian latent). The estimate stays valid — logq
                # matches the draws — but it IS a flow proposal; record
                # what actually ran instead of misreporting 't'.
                proposal = "flow"
            self.evidence_proposal_used = proposal
            if hasattr(self.flow, "_sample") and (
                    self.mesh is not None or proposal == "t"):
                # multi-host: the flow params are global mesh arrays and
                # jit may not mix them with a process-local key — drive
                # the sampler from a replicated uint32 seed instead
                key = (("EVS", n) if proposal == "flow"
                       else ("EVS", n, "t", self.evidence_nu))
                prog = self._prog_cache.get(key)
                if prog is None:
                    flow, nu = self.flow, self.evidence_nu
                    if proposal == "t":
                        fn = lambda params, seed: flow._sample_t(
                            params, jax.random.key(seed), n, nu)
                    else:
                        fn = lambda params, seed: flow._sample(
                            params, jax.random.key(seed), n)
                    prog = self._prog_cache[key] = jax.jit(fn)
                u_q, logq = prog(self.flow.params, self._seed32())
            else:
                u_q, logq = self.flow.sample(n, key=self._next_key())
            x_q, logdetj = self._scaler_inverse(u_q, self._scp())
            x_q = np.asarray(self._fetch(x_q), dtype=np.float64)
            logdetj = np.asarray(self._fetch(logdetj), dtype=np.float64)
            logq = np.asarray(self._fetch(logq), dtype=np.float64)

            logp = np.asarray(jax.device_get(jnp.asarray(self._logprior_host(
                jnp.asarray(x_q, dtype=jnp.float32)))), dtype=np.float64)
            finite = np.isfinite(logp)
            x_q, logdetj, logq, logp = (x_q[finite], logdetj[finite],
                                        logq[finite], logp[finite])
            logl, _ = self._log_like(x_q)
            logw = logl + logp + logdetj - logq
            # same guard as the device path: a NaN user likelihood or a
            # +inf overflow row would poison logz/k-hat; -inf rows stay
            logw = logw[~(np.isnan(logw) | np.isposinf(logw))]

        # tail diagnostic is always computed; "auto" self-applies the
        # Pareto smoothing above k-hat 0.5 instead of warning the user
        # into doing it
        logw_smooth, khat = psislw(logw)
        self.evidence_khat = float(khat)
        method = self.evidence_method
        if method == "auto":
            method = "psis" if khat > 0.5 else "is"
        self.evidence_method_used = method
        logw_used = logw_smooth if method == "psis" else logw

        m = logw_used.max()
        n_w = len(logw_used)
        logz = m + np.log(np.sum(np.exp(logw_used - m))) - np.log(n_w)

        # bootstrap error on device (an (n_boot, n_w) gather + logsumexp is
        # milliseconds there vs seconds of host f64 on one core); the
        # weights are max-normalized first so f32 is ample
        n_boot = max(n, 1000)
        dlogz = float(jax.device_get(_bootstrap_dlogz(
            jnp.asarray(logw_used - m, dtype=jnp.float32), self._next_key(),
            n_boot)))

        self.calls += n_w
        self.pbar.update_stats(dict(calls=self.calls))
        self.logz = float(logz)
        self.logz_err = dlogz
        if warn:
            self._warn_evidence_quality(dlogz, khat, self.evidence_method)
        return self.logz, self.logz_err

    @staticmethod
    def _warn_evidence_quality(dlogz, khat=None, method="auto"):
        """Warn on evidence-quality pathologies. `method` is the
        CONFIGURED estimator: under 'auto' the moderate-tail regime
        (0.5 < k-hat <= 0.7) is already remediated by Pareto smoothing,
        so only the hard k-hat > 0.7 regime warns; an explicit
        method='is' keeps the reference-style advisory warning."""
        import warnings
        if khat is not None and khat > 0.7:
            warnings.warn(
                f"Flow importance-sampling evidence is unreliable: the "
                f"Pareto tail-shape diagnostic k-hat={khat:.2f} exceeds 0.7 "
                f"(importance ratios have effectively infinite variance; "
                f"even Pareto smoothing cannot rescue the estimate, and the "
                f"quoted logz_err understates the true error). The "
                f"preconditioner under-covers the posterior, and the "
                f"automatic khat-triggered refinement rounds "
                f"(evidence_refine) have already been spent. What "
                f"measurably helps (25-D funnel numbers, RESULTS.md): more "
                f"refinement rounds (evidence_refine=4), a tighter "
                f"decorrelation target (corr_threshold=0.15: err -2.2 -> "
                f"-1.0; black-box runs already default to 0.15 -- go "
                f"lower, e.g. 0.05, at proportional call cost), a larger "
                f"flow (flow='nsf12'), larger n_effective, "
                f"longer training (train_config['patience']), and keeping "
                f"the whitening pre-transform on (the default). The SMC "
                f"persistent-sampling evidence (run(..., n_evidence=0)) "
                f"has no importance-ratio tail and auto-tightens its "
                f"decorrelation target, but shares the coverage "
                f"limitation on funnel-type geometries -- treat it as a "
                f"cross-check, not a rescue.", RuntimeWarning)
        elif khat is not None and khat > 0.5 and method == "is":
            warnings.warn(
                f"Flow importance-sampling ratios are heavy-tailed "
                f"(k-hat={khat:.2f} > 0.5): the plain-IS evidence converges "
                f"slowly. Consider Sampler(evidence_method='psis') for a "
                f"Pareto-smoothed estimate, or a larger n_evidence.",
                RuntimeWarning)
        elif dlogz > 0.5:
            warnings.warn(
                f"Flow importance-sampling evidence has a large bootstrap "
                f"error ({dlogz:.2f}): the preconditioner likely under-covers "
                f"the posterior. Consider more flow training epochs, a larger "
                f"flow, or a bigger n_effective.", RuntimeWarning)

    def _compute_bridge_evidence(self):
        """Flow-anchored bridge evidence (bridge.py): anneal a fresh
        population from the trained flow to the posterior along the
        latent-space geometric path and read logZ off that short
        ladder. Returns the diagnostics dict (logz/rungs/calls/ess_min)
        or None when prerequisites don't hold (no flow, or a
        multi-process mesh).
        Black-box likelihoods run the host-driven variant (device
        pullbacks + Python likelihood between steps)."""
        if not self.preconditioned:
            if self.evidence_bridge is True:
                raise ValueError(
                    "evidence_bridge=True requires precondition=True "
                    "(the bridge anneals in the flow's latent space).")
            return None
        if self.mesh is not None and self.mesh.multihost:
            return None  # replicated-host contract not wired here yet
        if not hasattr(self.flow, "kernel_inv"):
            return None
        from .bridge import (make_bridge_programs, run_bridge,
                             make_bridge_host_program, run_bridge_host)
        cache = self._prog_cache
        if self._loglike_dev is not None:
            key = ("BRIDGE", self.bridge_steps)
            if key not in cache:
                cache[key] = make_bridge_programs(
                    self.scaler, self._logprior_dev, self._loglike_dev,
                    self.n_dim, self.flow.kernel_inv,
                    n_steps=self.bridge_steps)
            init, rung = cache[key]
            res = run_bridge(init, rung, self.flow.params, self._scp(),
                             self.bridge_n, self._seed32,
                             fetch=self._fetch)
        else:
            # BLACK-BOX path: flow/scaler pullback on device, user
            # likelihood on host between steps (same split as the
            # stepped sweep driver; reference users with plain-numpy
            # likelihoods get the bridge too)
            key = "BRIDGE_HOST"
            if key not in cache:
                cache[key] = make_bridge_host_program(
                    self.scaler, self._logprior_dev, self.n_dim,
                    self.flow.kernel_inv)
            res = run_bridge_host(
                cache[key], lambda x: self._log_like(x)[0],
                self.flow.params, self._scp(), self.bridge_n,
                self.n_dim, self._rng, fetch=self._fetch,
                n_steps=self.bridge_steps)
        if res is not None:
            self.calls += res["calls"]
            if self.pbar is not None:
                self.pbar.update_stats(dict(calls=self.calls))
        return res

    def posterior(self, resample=False, return_blobs=False,
                  trim_importance_weights=True, return_logw=False,
                  ess_trim=0.99, bins_trim=1_000):
        """Posterior samples from the full history reweighted to beta=1
        (reference sampler.py:941-1009)."""
        if return_blobs and not self.have_blobs:
            raise ValueError("No blobs available.")
        samples = self.particles.get("x", flat=True)
        logl = self.particles.get("logl", flat=True)
        logp = self.particles.get("logp", flat=True)
        if return_blobs:
            blobs = self.particles.get("blobs", flat=True)
        logw, _ = self.particles.compute_logw_and_logz(
            1.0, recorrect=bool(self.particles.past.get("resid_exit")))
        weights = np.exp(logw)

        if trim_importance_weights:
            mask, weights = trim_weights(weights, ess=ess_trim, bins=bins_trim)
            idx = np.nonzero(mask)[0]
            samples, logl, logp, logw = samples[idx], logl[idx], logp[idx], logw[idx]
            if return_blobs:
                blobs = blobs[idx]

        if resample:
            if self.resample == "mult":
                idx_r = multinomial_resample(len(samples), weights, self._rng)
            else:
                idx_r = systematic_resample(len(samples), weights, self._rng)
            out = (samples[idx_r], logl[idx_r], logp[idx_r])
            return out + ((blobs[idx_r],) if return_blobs else ())

        w_or_logw = logw if return_logw else weights
        out = (samples, w_or_logw, logl, logp)
        return out + ((blobs,) if return_blobs else ())

    @property
    def results(self):
        return self.particles.compute_results()

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    _STATE_SCALARS = ("t", "calls", "n_effective", "n_active", "n_total",
                      "n_evidence", "proposal_scale", "warmup", "logz",
                      "logz_err", "flow_untrained", "dynamic_ratio",
                      "progress", "preconditioned", "metric", "sample",
                      "resample", "dynamic", "train_frequency", "have_blobs",
                      # added later (loaders tolerate their absence in
                      # older state dicts)
                      "n_steps", "n_max_steps", "plateau_z",
                      "plateau_floor", "n_leapfrog",
                      "pipeline", "evidence_method", "corr_threshold",
                      "calib_z", "_corr_auto", "evidence_refine",
                      "evidence_proposal", "evidence_nu", "bias_budget",
                      "bias_rate", "_bias_rate_auto", "bias_floor",
                      "_bias_floor_auto", "imh_every", "_imh_auto",
                      "evidence_bridge", "bridge_n", "bridge_steps")

    def state_dict(self):
        """Picklable snapshot: history, flow params, scaler/geometry
        moments, counters and RNG state (reference dill-pickles the whole
        __dict__ at sampler.py:1023-1049; here the snapshot is an explicit
        pytree-of-numpy for portability)."""
        to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a), tree)
        state = {k: getattr(self, k) for k in self._STATE_SCALARS}
        state["particles_past"] = self.particles.past
        state["flow_params"] = to_np(self.flow.params)
        state["prior_samples"] = self.prior_samples
        state["current_particles"] = self.current_particles
        state["rng_state"] = self._rng.bit_generator.state
        state["jax_key"] = np.asarray(jax.random.key_data(self._key))
        sc = self.scaler
        state["scaler"] = dict(
            mu=np.asarray(sc.mu), sigma=np.asarray(sc.sigma),
            L=None if sc.L is None else np.asarray(sc.L),
            L_inv=None if sc.L_inv is None else np.asarray(sc.L_inv),
            log_det_L=np.asarray(sc.log_det_L), fitted=sc._fitted)
        for name in ("u_geometry", "theta_geometry"):
            g = getattr(self, name)
            state[name] = None if g.t_mean is None else to_np(vars(g))
        return state

    def load_state_dict(self, state):
        # Config scalars that are BAKED INTO the jitted programs: if the
        # checkpoint's value differs from this instance's construction,
        # the programs must be rebuilt — silently running the
        # constructor's kernel while reporting the checkpoint's config
        # would be wrong in both directions.
        program_keys = ("sample", "preconditioned", "n_active", "n_steps",
                        "n_max_steps", "plateau_z", "plateau_floor",
                        "n_leapfrog",
                        "corr_threshold", "calib_z", "bias_budget",
                        "bias_rate", "bias_floor", "imh_every")
        rebuild = any(k in state and state[k] != getattr(self, k)
                      for k in program_keys)
        for k in self._STATE_SCALARS:
            if k in state:   # older state dicts lack late-added scalars
                setattr(self, k, state[k])
        if rebuild:
            self._build_device_fns()
        self.particles.past = state["particles_past"]
        # states written before the residual-hotness keys existed: pad
        # the (new) per-stage resid/hot lists so columns stay
        # index-aligned
        self.particles.past.setdefault(
            "resid", [0.0] * len(self.particles.past["beta"]))
        self.particles.past.setdefault(
            "resid_exit", [0.0] * len(self.particles.past["beta"]))
        self.particles.past.setdefault(
            "hot", [0.0] * len(self.particles.past["beta"]))
        self.particles.past.setdefault(
            "corr", [0.0] * len(self.particles.past["beta"]))
        self.particles.results_dict = None
        # invalidate device-loop caches tied to the previous run
        self._geom_dev = None
        self._hist_dev = None
        self._slot_count = 0
        self._synced_slots = 0
        self._dev_iter_stats = []
        self._scp_cache = None
        flow_params = jax.tree_util.tree_map(jnp.asarray,
                                             state["flow_params"])
        if (isinstance(self.flow, Flow)
                and not (isinstance(flow_params, dict)
                         and "pre" in flow_params
                         and "stack" in flow_params)):
            # pre-whitening checkpoint: migrate the bare transform stack
            # into the composite {'pre', 'stack'} layout (identity pre)
            from .models.flow import identity_pre
            flow_params = {
                "pre": jax.device_put(identity_pre(self.flow.n_dim)),
                "stack": flow_params}
        self.flow.params = flow_params
        self.prior_samples = state["prior_samples"]
        self.current_particles = state["current_particles"]
        self._rng.bit_generator.state = state["rng_state"]
        self._key = jax.random.wrap_key_data(jnp.asarray(state["jax_key"]))
        sc_state = state["scaler"]
        self.scaler.mu = jnp.asarray(sc_state["mu"])
        self.scaler.sigma = jnp.asarray(sc_state["sigma"])
        if sc_state.get("L") is not None:
            self.scaler.L = jnp.asarray(sc_state["L"])
            self.scaler.L_inv = jnp.asarray(sc_state["L_inv"])
            self.scaler.log_det_L = jnp.asarray(sc_state["log_det_L"])
        self.scaler._fitted = sc_state["fitted"]
        for name in ("u_geometry", "theta_geometry"):
            if state[name] is not None:
                g = getattr(self, name)
                for k, v in state[name].items():
                    setattr(g, k, None if v is None else jnp.asarray(v))

    # Pickling the Sampler object itself (reference sampler.py:922-939
    # supports this via __getstate__ dropping the pool): jitted programs
    # and pools are dropped and rebuilt on unpickling. The likelihood and
    # prior must themselves be picklable.
    _UNPICKLABLE = ("_sweep_plain", "_sweep_precond", "_scaler_forward",
                    "_scaler_inverse", "_loglike_host_jit", "_logprior_dev",
                    "_loglike_dev",
                    "_logprior_host", "_like_batch_fn", "pool", "distribute",
                    "pbar", "flow", "scaler", "mesh", "_key", "_rng",
                    "u_geometry", "theta_geometry",
                    "_prog_cache", "_geom_dev", "_hist_dev",
                    "_dev_iter_stats", "_scp_cache")

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_runtime_state"] = self.state_dict()
        for k in self._UNPICKLABLE:
            state.pop(k, None)
        if isinstance(self.flow, Flow):
            state["_flow_config"] = (self.flow.n_dim,
                                     f"{self.flow.kind}{self.flow.n_transforms}",
                                     self.flow.bins, self.flow.whiten_mode)
        else:
            # custom flow object (docs/flows.md): pickled whole — the
            # protocol requires custom flows to be picklable for
            # Sampler pickling/checkpoint round-trips
            state["_flow_config"] = None
            state["_flow_obj"] = self.flow
        state["_scaler_config"] = dict(
            n_dim=self.scaler.n_dim,
            bounds=np.stack([np.asarray(self.scaler.low),
                             np.asarray(self.scaler.high)], axis=1),
            periodic=self.scaler.periodic,
            reflective=self.scaler.reflective,
            transform=self.scaler.transform,
            scale=self.scaler.scale, diagonal=self.scaler.diagonal)
        return state

    def __setstate__(self, state):
        runtime = state.pop("_runtime_state")
        flow_config = state.pop("_flow_config")
        flow_obj = state.pop("_flow_obj", None)
        scaler_cfg = state.pop("_scaler_config")
        self.__dict__.update(state)
        # attributes added after pickling support shipped: backfill so
        # pickles from every earlier version unpickle and run
        for attr, default in (("pipeline", 1), ("n_leapfrog", 5),
                              ("device_loop", "auto"), ("plateau_z", 0.75),
                              ("plateau_floor", 4.0),
                              ("evidence_method", "is"),
                              ("evidence_khat", None),
                              ("evidence_method_used", None),
                              ("profile_dir", None),
                              ("corr_threshold", 0.5),
                              ("calib_z", 3.0),
                              ("_corr_auto", False),
                              ("evidence_refine", 2),
                              ("evidence_proposal", "auto"),
                              ("evidence_nu", 5.0),
                              ("evidence_proposal_used", None),
                              ("bias_rate", 0.0),
                              ("_bias_rate_auto", False),
                              ("bias_floor", 0.0),
                              ("_bias_floor_auto", True),
                              ("imh_every", 0),
                              ("_imh_auto", False),
                              ("_refine_round", 0)):
            self.__dict__.setdefault(attr, default)
        self.pool = None
        self.distribute = map
        self.pbar = None
        self.mesh = None
        self._rng = np.random.default_rng(0)
        self._key = jax.random.key(0)
        if flow_config is not None:
            # 3-tuple accepted for pre-whitening checkpoint compatibility
            n_dim, arch, bins, whiten = (tuple(flow_config) + (True,))[:4]
            self.flow = Flow(n_dim, arch, bins=bins, whiten=whiten)
        else:
            self.flow = flow_obj
        self.scaler = Reparameterize(**scaler_cfg)
        self.u_geometry = Geometry()
        self.theta_geometry = Geometry()
        self._build_device_fns()
        self.load_state_dict(runtime)

    def save_state(self, path):
        """Checkpoint write. Default: atomic pickle (temp + flush + fsync
        + rename, as the reference does for NFS safety at
        sampler.py:1031-1049). A path ending in '.orbax' selects the
        orbax/tensorstore directory format instead
        (utils/checkpoint.py) — mmap-able and inspectable; it needs
        the optional orbax package."""
        path = Path(path)
        # Multi-process (SPMD-replicated host) runs: every process holds
        # the identical state and calls save_state in lockstep — state_dict
        # itself is collective-free (the device loop syncs history, a
        # collective, BEFORE saving), but only process 0 may touch the
        # file: concurrent writers racing the same temp+rename would
        # corrupt the checkpoint on a shared filesystem.
        state = self.state_dict()
        if jax.process_count() > 1 and jax.process_index() != 0:
            return
        print(f"Saving PMC state to {path}")
        from .utils.checkpoint import is_orbax_path, save_orbax
        if is_orbax_path(path):
            save_orbax(state, path)
            return
        path.parent.mkdir(parents=True, exist_ok=True)
        temp_path = path.with_suffix(f".temp-{os.getpid()}")
        with open(temp_path, "wb") as f:
            pickle.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(temp_path, path)

    def load_state(self, path):
        from .utils.checkpoint import is_orbax_path, load_orbax
        if is_orbax_path(path):
            self.load_state_dict(load_orbax(path))
            return
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.load_state_dict(state)
