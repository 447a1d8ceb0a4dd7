"""Normalizing flows: masked-autoregressive MAF / NSF stacks + trainer.

This is the JAX replacement for the reference's torch/zuko flows
(/root/reference/pocomc/flow.py:13-384). Same capacity and architecture
menu ('maf3'|'maf6'|'maf12'|'nsf3'|'nsf6'|'nsf12'; flow.py:54-86): T
masked-autoregressive transforms with alternating variable order, each a
3-hidden-layer residual MADE with n_hidden = max(next_pow2(3*d), 32),
standard-normal base. NSF uses 8-bin rational-quadratic splines.

Directions (zuko convention, flow.py:99-132):
  forward : data -> latent, one MADE pass per transform (density direction)
  inverse : latent -> data, autoregressive -> a `lax.scan` over dimensions
            with one MADE pass per dim per transform

Training (`Flow.fit`) ports the semantics of flow.py:165-384: shuffled
optional validation split, AdamW, weighted NLL `sum(-logq * w * 1000) /
sum(w)` per batch, optional Laplace/Gaussian weight regularization,
grad-norm clipping, ReduceLROnPlateau-style annealing, best-state snapshot
and early stop after 1.5*patience stale epochs. The epoch is one jitted
`lax.scan` over batches; only the early-stopping decision syncs to host.
Variable train-set sizes are padded with zero-weight rows to keep shapes
static across SMC iterations.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax

from .made import init_made, apply_made, apply_made_dim
from . import transforms as tr


def _next_pow2(n: int) -> int:
    return 1 if n <= 0 else 2 ** ((n - 1).bit_length())


def identity_pre(n_dim: int) -> dict:
    """Identity parameters for the affine whitening pre-transform.

    Conventions: forward `y = (x - mean) @ w_fwd` with
    `w_fwd = inv(L).T` for `L = chol(weighted cov)`; inverse
    `x = y @ w_inv + mean` with `w_inv = L.T`; `ladj` is the constant
    forward log|det dy/dx| = -sum(log diag L).
    """
    return dict(mean=np.zeros(n_dim, np.float32),
                w_fwd=np.eye(n_dim, dtype=np.float32),
                w_inv=np.eye(n_dim, dtype=np.float32),
                ladj=np.float32(0.0))


def fit_pre_numpy(x, w, prev_pre, rel_eps=1e-6, min_ess=8.0,
                  mode="full"):
    """Closed-form weighted whitening fit (host numpy).

    `mode='full'` whitens with the covariance Cholesky (removes
    rotation AND scale); `mode='diag'` uses per-dimension standard
    deviations only (scale, no rotation — preserves axis-aligned
    structure on curved targets). Falls back to `prev_pre` when the
    weighted covariance is not positive definite or the training set is
    degenerate: weight ESS below `min_ess`, or a (near-)zero
    covariance — whitening a point mass would amplify the space by the
    regularization floor's inverse and destroy the flow.
    """
    n_dim = x.shape[-1]
    wsum = float(np.sum(w))
    if not np.isfinite(wsum) or wsum <= 0 or x.shape[0] <= n_dim:
        return prev_pre
    wn = (w / wsum).astype(np.float64)
    if 1.0 / np.sum(wn * wn) < min_ess:
        return prev_pre
    xf = x.astype(np.float64)
    mean = wn @ xf
    xc = xf - mean
    if mode == "diag":
        var = wn @ (xc * xc)
        tr = float(np.sum(var))
        if not np.isfinite(tr) or tr <= n_dim * 1e-10:
            return prev_pre
        chol = np.diag(np.sqrt(var + rel_eps * tr / n_dim))
    else:
        cov = (xc * wn[:, None]).T @ xc
        tr = float(np.trace(cov))
        if not np.isfinite(tr) or tr <= n_dim * 1e-10:
            return prev_pre
        cov += (rel_eps * tr / n_dim) * np.eye(n_dim)
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            return prev_pre
    if not np.all(np.isfinite(chol)):
        return prev_pre
    chol_inv = np.linalg.solve(chol, np.eye(n_dim))
    return dict(mean=mean.astype(np.float32),
                w_fwd=chol_inv.T.astype(np.float32),
                w_inv=chol.T.astype(np.float32),
                ladj=np.float32(-np.sum(np.log(np.diag(chol)))))


def fit_pre_jax(x, w, rel_eps=1e-6, min_ess=8.0, mode="full"):
    """Traceable weighted whitening fit (same conventions, modes, and
    degeneracy guards as `fit_pre_numpy`; identity fallback instead of
    prev_pre). Traced at matmul precision float32 like all other flow
    compute: a bf16-quantized covariance of an ill-conditioned training
    set could fail the PD guard or degrade the whitening silently."""
    with jax.default_matmul_precision("float32"):
        n_dim = x.shape[-1]
        eye = jnp.eye(n_dim, dtype=x.dtype)
        wn = w / jnp.maximum(jnp.sum(w), 1e-30)
        mean = wn @ x
        xc = x - mean
        if mode == "diag":
            var = wn @ (xc * xc)
            tr = jnp.sum(var)
            chol = jnp.diag(jnp.sqrt(var + rel_eps * tr / n_dim + 1e-12))
        else:
            cov = (xc * wn[:, None]).T @ xc
            tr = jnp.trace(cov)
            cov = cov + (rel_eps * tr / n_dim + 1e-12) * eye
            chol = jnp.linalg.cholesky(cov)
        ok = (jnp.all(jnp.isfinite(chol))
              & (1.0 / jnp.sum(wn * wn) >= min_ess)
              & jnp.isfinite(tr) & (tr > n_dim * 1e-10))
        chol = jnp.where(ok, chol, eye)
        chol_inv = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
        return dict(mean=jnp.where(ok, mean, jnp.zeros_like(mean)),
                    w_fwd=chol_inv.T, w_inv=chol.T,
                    ladj=-jnp.sum(jnp.log(jnp.diagonal(chol))))


_ARCHS = {
    "maf3": ("maf", 3), "maf6": ("maf", 6), "maf12": ("maf", 12),
    "nsf3": ("nsf", 3), "nsf6": ("nsf", 6), "nsf12": ("nsf", 12),
    # coupling-layer spline flows (one-pass inverse; models/coupling.py)
    "nsfc3": ("nsfc", 3), "nsfc6": ("nsfc", 6), "nsfc12": ("nsfc", 12),
}

# Module-level cache of compiled program sets, keyed by flow configuration.
# Masks/orders are deterministic functions of the config, so every Flow
# instance with the same config shares the same traced+compiled functions —
# a fresh Sampler per run would otherwise recompile everything (observed:
# 137 s vs 20 s for the Rosenbrock-10 quickstart).
_PROGRAM_CACHE: dict = {}


class Flow:
    """Masked-autoregressive normalizing flow with a trainer.

    Parameters are a pytree (`self.params`); all compute methods are
    functional in the params so the MCMC kernels can consume them as jit
    arguments without retracing.
    """

    def __init__(self, n_dim: int, flow: str = "nsf6", bins: int = 8,
                 seed: int = 0, whiten: bool | str = True):
        if flow not in _ARCHS:
            raise ValueError(
                f"Invalid flow {flow!r}. Choose from {sorted(_ARCHS)}.")
        if whiten not in (True, False, None, "none", "full", "diag"):
            raise ValueError(
                f"Invalid whiten {whiten!r}. Choose True/'full', 'diag', "
                f"or False/'none'.")
        # Weighted full-covariance whitening pre-transform, refit from the
        # live (weighted) training set at every `fit`. The autoregressive
        # stack fits in whitened space, so rotated / ill-conditioned
        # targets (which the per-dim spline tails cannot carry — see
        # RESULTS.md "50-D evidence tail study") reduce to near-isotropic
        # ones. The reference has no analog: its scaler whitens once on
        # prior samples only (/root/reference/pocomc/sampler.py:438-440).
        self.whiten = whiten in (True, "full", "diag")
        # 'full' removes rotation and scale (the 50-D rotated-Gaussian
        # fix); 'diag' rescales per-dimension only — preserves
        # axis-aligned structure on strongly curved targets where a
        # rotation can cost the autoregressive stack accuracy.
        self.whiten_mode = ("diag" if whiten == "diag"
                            else ("full" if self.whiten else None))
        self.n_dim = int(n_dim)
        self.kind, self.n_transforms = _ARCHS[flow]
        self.bins = int(bins)
        self.n_hidden = max(_next_pow2(3 * self.n_dim), 32)
        self.hidden_sizes = [self.n_hidden] * 3
        self.n_params = (tr.AFFINE_N_PARAMS if self.kind == "maf"
                         else tr.rqs_n_params(self.bins))

        # Host-numpy initialization + ONE device transfer of the finished
        # pytree: eager per-layer jax.random/stack ops each pay a device
        # round trip at construction time.
        rng = np.random.default_rng(seed)
        self.params = []
        self.masks = []
        if self.kind == "nsfc":
            if self.n_dim < 2:
                raise ValueError(
                    "Coupling flows ('nsfc*') need n_dim >= 2 (the "
                    "dimensions are split into two halves); use 'maf*' or "
                    "'nsf*' for 1-D problems.")
            from .coupling import make_coupling_masks, init_coupling
            self.coupling_masks = make_coupling_masks(self.n_dim,
                                                      self.n_transforms)
            for t in range(self.n_transforms):
                self.params.append(init_coupling(
                    rng, self.n_dim, self.hidden_sizes, self.n_params,
                    self.coupling_masks[t]))
            self.orders = []
            self._inv_dim_order = []
        else:
            # Alternating autoregressive orders (zuko MAF behavior).
            self.orders = []
            base = np.arange(self.n_dim)
            for t in range(self.n_transforms):
                self.orders.append(base if t % 2 == 0 else base[::-1].copy())
            for t in range(self.n_transforms):
                p, m = init_made(rng, self.n_dim, self.hidden_sizes,
                                 self.n_params, self.orders[t])
                self.params.append(p)
                self.masks.append(m)
            # inverse scan processes dims in increasing autoregressive
            # degree: position k updates dim argsort(order)[k]
            self._inv_dim_order = [np.argsort(o).astype(np.int32)
                                   for o in self.orders]
            # stack the transform axis: params become a list of layer
            # dicts with (T, ...) leaves so the forward/inverse are a
            # single lax.scan over transforms (see _build_fns)
            n_layers = len(self.params[0])
            self.params = [
                {k: np.stack([self.params[t][l][k]
                              for t in range(self.n_transforms)])
                 for k in ("w", "b")}
                for l in range(n_layers)]
        # params = {"pre": affine whitening map, "stack": transform stack}.
        # pre is identity until the first whitening fit; it is NOT trained
        # by gradient descent (fit recomputes it in closed form).
        self.params = jax.device_put(
            {"pre": identity_pre(self.n_dim), "stack": self.params})

        self._config_key = (self.n_dim, self.kind, self.n_transforms,
                            self.bins, tuple(self.hidden_sizes))
        cached = _PROGRAM_CACHE.get(self._config_key)
        if cached is None:
            self._build_fns()
            _PROGRAM_CACHE[self._config_key] = dict(
                forward=self._forward, inverse=self._inverse,
                log_prob=self._log_prob, sample=self._sample,
                sample_t=self._sample_t,
                stack_log_prob=self._stack_log_prob,
                forward_jit=self._forward_jit, inverse_jit=self._inverse_jit,
                log_prob_jit=self._log_prob_jit, sample_jit=self._sample_jit,
                kernel_fwd=self.kernel_fwd, kernel_inv=self.kernel_inv,
                tx_cache={}, chunk_cache={})
        else:
            self._forward = cached["forward"]
            self._stack_log_prob = cached["stack_log_prob"]
            self._inverse = cached["inverse"]
            self._log_prob = cached["log_prob"]
            self._sample = cached["sample"]
            self._sample_t = cached["sample_t"]
            self._forward_jit = cached["forward_jit"]
            self._inverse_jit = cached["inverse_jit"]
            self._log_prob_jit = cached["log_prob_jit"]
            self._sample_jit = cached["sample_jit"]
            self.kernel_fwd = cached["kernel_fwd"]
            self.kernel_inv = cached["kernel_inv"]
        self._tx_cache = _PROGRAM_CACHE[self._config_key]["tx_cache"]
        self._chunk_cache = _PROGRAM_CACHE[self._config_key]["chunk_cache"]

    # -- functional core -----------------------------------------------------

    def _elem_fwd(self, x, p):
        if self.kind == "maf":
            return tr.affine_forward(x, p)
        return tr.rqs_forward(x, p, self.bins)

    def _elem_inv(self, z, p):
        if self.kind == "maf":
            return tr.affine_inverse(z, p)
        return tr.rqs_inverse(z, p, self.bins)

    def _build_fns(self):
        n_dim, n_params = self.n_dim, self.n_params
        masks = self.masks
        inv_orders = self._inv_dim_order  # np arrays -> trace constants

        if self.kind == "nsfc":
            from .coupling import coupling_forward, coupling_inverse
            cmasks = self.coupling_masks
            bins = self.bins
            n_transforms = self.n_transforms

            def forward(params, x):
                ladj = jnp.zeros(x.shape[0], x.dtype)
                for t in range(n_transforms):
                    x, l = coupling_forward(params[t], cmasks[t], x, bins)
                    ladj = ladj + l
                return x, ladj

            def inverse(params, z):
                ladj = jnp.zeros(z.shape[0], z.dtype)
                for t in reversed(range(n_transforms)):
                    z, l = coupling_inverse(params[t], cmasks[t], z, bins)
                    ladj = ladj + l
                return z, ladj

            self._finalize_fns(forward, inverse)
            return

        def transform_inverse(tp, tm, z, dim_order):
            """Sequential inverse: scan over dims in degree order. Each
            step computes only the current dim's parameter block
            (apply_made_dim) and accumulates the ladj in the carry —
            no extra full pass at the end."""

            def body(carry, dim):
                x, ladj = carry
                p_dim = apply_made_dim(tp, tm, x, dim, n_params)
                z_dim = jnp.take(z, dim, axis=1)         # (n,)
                x_dim, l = self._elem_inv(z_dim, p_dim)
                x = x.at[:, dim].set(x_dim)
                return (x, ladj + l), None

            x0 = jnp.zeros_like(z)
            ladj0 = jnp.zeros(z.shape[0], z.dtype)
            (x, ladj), _ = jax.lax.scan(body, (x0, ladj0), dim_order)
            return x, ladj

        # Default path: ONE lax.scan over the transform stack. The
        # per-transform parameters, masks and inverse dim orders are
        # stacked on a leading T axis (Flow.__init__), so the traced
        # graph and compiled HLO contain a single transform body instead
        # of n_transforms inlined copies, which cuts tracing and compile
        # time (a cold-start cost) by the transform count.
        # numpy stacks: these enter the traced functions as closure
        # constants, so no eager device transfer happens here
        masks_st = [np.stack([masks[t][l] for t in range(self.n_transforms)])
                    for l in range(len(masks[0]))] if masks else []
        inv_st = (np.stack(self._inv_dim_order)
                  if self._inv_dim_order else np.zeros((0, n_dim), np.int32))

        def forward(params, x):
            """data -> latent; returns (z, sum ladj log|dz/dx|)."""

            def body(carry, sl):
                x, ladj = carry
                tp, tm = sl
                p = apply_made(tp, tm, x, n_dim, n_params)
                x, l = self._elem_fwd(x, p)
                return (x, ladj + jnp.sum(l, axis=-1)), None

            ladj0 = jnp.zeros(x.shape[0], x.dtype)
            (z, ladj), _ = jax.lax.scan(body, (x, ladj0), (params, masks_st))
            return z, ladj

        def inverse(params, z):
            """latent -> data; returns (x, sum ladj log|dx/dz|)."""

            def body(carry, sl):
                z, ladj = carry
                tp, tm, dim_order = sl
                z, l = transform_inverse(tp, tm, z, dim_order)
                return (z, ladj + l), None

            ladj0 = jnp.zeros(z.shape[0], z.dtype)
            (x, ladj), _ = jax.lax.scan(body, (z, ladj0),
                                        (params, masks_st, inv_st),
                                        reverse=True)
            return x, ladj

        self._finalize_fns(forward, inverse)

    def _finalize_fns(self, stack_forward, stack_inverse):
        """Shared density / sampling / jit / kernel-contract wrappers.

        `stack_forward`/`stack_inverse` operate on the transform stack
        only; the public functions compose the affine whitening `pre`
        layer around them (see `identity_pre` for conventions).

        Every flow computation is traced under matmul precision
        'float32': reduced-precision matmul inputs (bf16, or the TF32
        that the default precision allows on GPUs) quantize the MADE activations/spline
        parameters enough to produce zero-width spline bins, which turns
        one training epoch into inf/NaN loss. Found with bf16 inputs on
        a mid-run SMC training set that trains cleanly on CPU and at f32
        precision (RESULTS.md 'bf16 precision postmortem'); TF32 is not
        yet measured (ROADMAP speed item 3)."""
        n_dim = self.n_dim

        def forward(params, x):
            with jax.default_matmul_precision("float32"):
                pre = params["pre"]
                y = (x - pre["mean"]) @ pre["w_fwd"]
                z, ladj = stack_forward(params["stack"], y)
                return z, ladj + pre["ladj"]

        def inverse(params, z):
            with jax.default_matmul_precision("float32"):
                pre = params["pre"]
                y, ladj = stack_inverse(params["stack"], z)
                return y @ pre["w_inv"] + pre["mean"], ladj - pre["ladj"]

        def stack_log_prob(stack, y):
            with jax.default_matmul_precision("float32"):
                z, ladj = stack_forward(stack, y)
                base = (-0.5 * jnp.sum(z * z, axis=-1)
                        - 0.5 * n_dim * math.log(2 * math.pi))
                return base + ladj

        def log_prob(params, x):
            with jax.default_matmul_precision("float32"):
                pre = params["pre"]
                y = (x - pre["mean"]) @ pre["w_fwd"]
                return stack_log_prob(params["stack"], y) + pre["ladj"]

        def sample(params, key, size):
            z = jax.random.normal(key, (size, n_dim))
            x, ladj = inverse(params, z)
            base = -0.5 * jnp.sum(z * z, axis=-1) - 0.5 * n_dim * math.log(2 * math.pi)
            return x, base - ladj

        def sample_t(params, key, size, nu):
            """Heavier-tailed draws through the SAME trained transform:
            z ~ multivariate Student-t_nu(0, I) in latent space, pushed
            through the flow's inverse. Returns (x, logq(x)) with the
            EXACT proposal density — for any latent base b(z), the
            pushforward density at x is b(z) - log|det dx/dz| — so the
            draws are a drop-in importance-sampling proposal (used by the
            sampler's evidence estimator: the Gaussian-latent flow
            under-covers target tails it never saw training data in,
            which biases finite-n flow-IS logZ low; measured in
            RESULTS.md round 3 "defensive evidence proposal")."""
            from jax.scipy.special import gammaln
            kz, kg = jax.random.split(key)
            zn = jax.random.normal(kz, (size, n_dim))
            g = 2.0 * jax.random.gamma(kg, nu / 2.0, (size, 1))
            z = zn * jnp.sqrt(nu / g)
            x, ladj = inverse(params, z)
            base = (gammaln((nu + n_dim) / 2.0) - gammaln(nu / 2.0)
                    - 0.5 * n_dim * jnp.log(nu * jnp.pi)
                    - 0.5 * (nu + n_dim)
                    * jnp.log1p(jnp.sum(z * z, axis=-1) / nu))
            return x, base - ladj

        self._forward = forward
        self._inverse = inverse
        self._stack_log_prob = stack_log_prob
        self._log_prob = log_prob
        self._sample = sample
        self._sample_t = sample_t
        self._forward_jit = jax.jit(forward)
        self._inverse_jit = jax.jit(inverse)
        self._log_prob_jit = jax.jit(log_prob)
        self._sample_jit = jax.jit(sample, static_argnames=("size",))

        # Kernel-facing contract (mirrors reference tools.py:318-349
        # flow_numpy_wrapper): both directions report log|det du/dtheta|.
        def kernel_fwd(params, u):
            theta, ladj = forward(params, u)
            return theta, -ladj

        def kernel_inv(params, theta):
            u, ladj = inverse(params, theta)
            return u, ladj

        self.kernel_fwd = kernel_fwd
        self.kernel_inv = kernel_inv

    # -- public compute API ----------------------------------------------

    def forward(self, x):
        """data -> (latent, log|det dz/dx|)."""
        return self._forward_jit(self.params, jnp.asarray(x))

    def inverse(self, z):
        """latent -> (data, log|det dx/dz|)."""
        return self._inverse_jit(self.params, jnp.asarray(z))

    def log_prob(self, x):
        return self._log_prob_jit(self.params, jnp.asarray(x))

    def sample(self, size=1, key=None):
        if key is None:
            key = jax.random.key(np.random.default_rng().integers(2**31 - 1))
        return self._sample_jit(self.params, key, size)

    # -- training ----------------------------------------------------------

    @staticmethod
    def _weight_leaves(params):
        """All 'w' leaves of a params pytree, independent of whether the
        transform axis is stacked (scan path) or a per-transform list."""
        return [leaf for path, leaf in
                jax.tree_util.tree_leaves_with_path(params)
                if isinstance(path[-1], jax.tree_util.DictKey)
                and path[-1].key == "w"]

    def _loss_fn(self, params, xb, wb, laplace_scale, gaussian_scale):
        """Weighted NLL of the transform STACK on pre-whitened inputs.

        The whitening layer's constant ladj is omitted: it shifts the
        loss uniformly and cannot change gradients or best-epoch
        selection within a fit."""
        logq = self._stack_log_prob(params, xb)
        loss = jnp.sum(-logq * wb * 1000.0) / jnp.maximum(jnp.sum(wb), 1e-30)
        if laplace_scale is not None or gaussian_scale is not None:
            reg = 0.0
            for w in self._weight_leaves(params):
                if laplace_scale is not None:
                    reg += jnp.sum(jnp.abs(w)) / laplace_scale
                if gaussian_scale is not None:
                    reg += jnp.sum(w ** 2) / (2.0 * gaussian_scale**2)
            loss = loss + reg
        return loss

    def fit(self, x, weights=None, validation_split=0.0, epochs=1000,
            batch_size=1000, patience=20, learning_rate=1e-3,
            weight_decay=0.0, laplace_scale=None, gaussian_scale=None,
            annealing=True, noise=None, shuffle=True, clip_grad_norm=1.0,
            verbose=0, seed=None, mesh=None, epoch_chunk="auto"):
        """Weighted maximum-likelihood training. See module docstring.

        `epoch_chunk` epochs run inside ONE device call (a lax.scan over
        epochs with on-device best-parameter tracking), so the host only
        syncs once per chunk — essential when the accelerator sits behind
        a high-latency link. Early stopping is evaluated at chunk
        granularity; "auto" picks ~patience/2 so the stopping lag stays
        well under the reference's 1.5*patience stale-epoch rule
        (reference flow.py:291-374 syncs every epoch).
        """
        # ALL preprocessing (shuffle, split, padding, bucketing) happens in
        # host numpy with ONE device transfer at the end: eager jnp ops here
        # would each pay a dispatch to the accelerator.
        x = np.asarray(jax.device_get(x), dtype=np.float32)
        n_samples = x.shape[0]
        if weights is None:
            w_all = np.full((n_samples,), 1.0 / n_samples, dtype=np.float32)
        else:
            w_all = np.asarray(jax.device_get(weights), dtype=np.float32)

        # Refit the whitening pre-layer on the weighted training set, then
        # map the data through it — the stack trains in whitened space.
        pre_prev = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(self.params["pre"]))
        pre = (fit_pre_numpy(x, w_all, pre_prev, mode=self.whiten_mode)
               if self.whiten else pre_prev)
        x = (x - pre["mean"]) @ pre["w_fwd"]

        rng = np.random.default_rng(seed)
        if shuffle:
            perm = rng.permutation(n_samples)
            x = x[perm]
            w_all = w_all[perm]

        # Bucket the TOTAL sample count to a power of two up front (zero-
        # weight duplicate rows, shuffled in) so every downstream shape —
        # split, batch count, validation pad — is a pure function of the
        # bucket: across an SMC run whose trimmed history drifts every
        # iteration this collapses train-program recompiles to O(log n).
        n_bucket = _next_pow2(n_samples)
        if n_bucket > n_samples:
            pad_idx = rng.integers(0, n_samples, size=n_bucket - n_samples)
            x = np.concatenate([x, x[pad_idx]], axis=0)
            w_all = np.concatenate(
                [w_all, np.zeros(n_bucket - n_samples, w_all.dtype)], axis=0)
            if shuffle:
                perm = rng.permutation(n_bucket)
                x = x[perm]
                w_all = w_all[perm]
            n_samples = n_bucket

        if noise is not None:
            # mean nearest-neighbor distance, vectorized (reference
            # flow.py:240-245 is an O(n^2) python loop)
            d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
            np.fill_diagonal(d2, np.inf)
            d2[d2 <= 0.0] = np.inf
            noise_scale = float(noise) * float(np.mean(np.sqrt(np.min(d2, axis=1))))
        else:
            noise_scale = 0.0

        validation = validation_split > 0.0
        if validation:
            n_train = int(validation_split * n_samples)
            x_train, w_train = x[:n_train], w_all[:n_train]
            x_val, w_val = x[n_train:], w_all[n_train:]
        else:
            x_train, w_train = x, w_all
            x_val = w_val = None

        def pad_pow2_rows(xa, wa, n_target):
            n_pad = n_target - xa.shape[0]
            if n_pad <= 0:
                return xa, wa
            reps = -(-n_pad // xa.shape[0])
            pad_x = np.tile(xa, (reps, 1))[:n_pad]
            return (np.concatenate([xa, pad_x], axis=0),
                    np.concatenate([wa, np.zeros(n_pad, wa.dtype)], axis=0))

        batch_size = max(1, min(int(batch_size), x_train.shape[0]))
        # floor to a power of two: callers pass data-dependent batch sizes
        # (reference sampler.py:659 uses len(u)//2) which would otherwise
        # force a recompile per SMC iteration
        batch_size = 1 << (batch_size.bit_length() - 1)
        # Bucket the batch count to a power of two so recompiles across SMC
        # iterations (whose trimmed-history size drifts every round) are
        # bounded to O(log) distinct shapes. Padding rows carry zero weight
        # and are invisible to the per-batch weighted loss.
        n_batches = _next_pow2(-(-x_train.shape[0] // batch_size))
        n_train_real = float(x_train.shape[0])
        x_train, w_train = pad_pow2_rows(x_train, w_train, n_batches * batch_size)
        n_train_total = x_train.shape[0]

        if validation:
            n_val_real = float(x_val.shape[0])
            x_val, w_val = pad_pow2_rows(x_val, w_val, _next_pow2(x_val.shape[0]))
            x_val = jnp.asarray(x_val)
            w_val = jnp.asarray(w_val)

        if mesh is not None:
            # data-parallel training: samples sharded over the particle
            # mesh; parameter grads all-reduce automatically under jit.
            # Row counts that don't divide the mesh (pow2 buckets on a
            # non-pow2 mesh) fall back to replicated inputs inside
            # shard_particles — same program, no data parallelism.
            x_train = mesh.shard_particles(x_train)
            w_train = mesh.shard_particles(w_train)
            params = mesh.replicate(self.params["stack"])
        else:
            x_train = jnp.asarray(x_train)
            w_train = jnp.asarray(w_train)
            params = self.params["stack"]

        # Optimizer and compiled chunk programs are cached on the instance:
        # `fit` is called once per SMC iteration and redefining the jitted
        # closure each time would defeat JAX's compilation cache entirely
        # (observed: 12 identical recompiles per run before caching).
        tx_key = (clip_grad_norm, weight_decay)
        if tx_key not in self._tx_cache:
            self._tx_cache[tx_key] = optax.inject_hyperparams(
                lambda lr: optax.chain(
                    optax.clip_by_global_norm(clip_grad_norm),
                    optax.adamw(lr, weight_decay=weight_decay),
                )
            )(lr=learning_rate)
        tx = self._tx_cache[tx_key]
        opt_state = tx.init(params)
        opt_state.hyperparams["lr"] = jnp.asarray(learning_rate, jnp.float32)

        if not validation:
            x_val = jnp.zeros((1, self.n_dim), jnp.float32)
            w_val = jnp.zeros((1,), jnp.float32)
            n_val_real = 1.0

        chunk_key = (n_train_total, n_batches, batch_size, bool(validation),
                     bool(shuffle), noise is not None, tx_key,
                     laplace_scale, gaussian_scale)
        full_key = ("full",) + chunk_key
        if chunk_key not in self._chunk_cache:
            loss_fn = partial(self._loss_fn, laplace_scale=laplace_scale,
                              gaussian_scale=gaussian_scale)
            n_dim = self.n_dim
            has_noise = noise is not None
            use_val = bool(validation)
            do_shuffle = bool(shuffle)

            def one_epoch(carry, _):
                (params, opt_state, key, best_params, best_loss, best_idx,
                 epoch_idx, xt, wt, xv, wv, nscale, n_tr, n_vl) = carry
                key, k_perm, k_noise = jax.random.split(key, 3)
                order = (jax.random.permutation(k_perm, n_train_total)
                         if do_shuffle else jnp.arange(n_train_total))
                xb = xt[order].reshape(n_batches, batch_size, n_dim)
                wb = wt[order].reshape(n_batches, batch_size)

                def step(c, batch):
                    p, o, k = c
                    xi, wi = batch
                    if has_noise:
                        k, sub = jax.random.split(k)
                        xi = xi + nscale * jax.random.normal(sub, xi.shape)
                    loss, grads = jax.value_and_grad(loss_fn)(p, xi, wi)
                    updates, o = tx.update(grads, o, p)
                    p = optax.apply_updates(p, updates)
                    return (p, o, k), loss

                (params, opt_state, _), losses = jax.lax.scan(
                    step, (params, opt_state, k_noise), (xb, wb))
                train_loss = jnp.sum(losses) / n_tr
                if use_val:
                    current = loss_fn(params, xv, wv) / n_vl
                else:
                    current = train_loss

                improved = current < best_loss
                best_params = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(improved, a, b), params, best_params)
                best_loss = jnp.where(improved, current, best_loss)
                best_idx = jnp.where(improved, epoch_idx, best_idx)
                carry = (params, opt_state, key, best_params, best_loss,
                         best_idx, epoch_idx + 1, xt, wt, xv, wv, nscale,
                         n_tr, n_vl)
                return carry, (train_loss, current)

            self._chunk_cache[chunk_key] = jax.jit(
                lambda carry, length: jax.lax.scan(one_epoch, carry, None,
                                                   length=length),
                static_argnames=("length",))

            # Single-call variant: the whole fit (epoch loop + early stop)
            # as ONE lax.while_loop program — zero host syncs per epoch.
            # Usable whenever the host-side plateau LR schedule is off.
            def train_full(carry, max_epochs, stop_after):
                losses0 = jnp.zeros((max_epochs, 2), jnp.float32)

                def cond(state):
                    carry, _ = state
                    epoch_idx, best_idx = carry[6], carry[5]
                    return ((epoch_idx < max_epochs)
                            & (epoch_idx - 1 - best_idx < stop_after))

                def body(state):
                    carry, losses = state
                    epoch_idx = carry[6]
                    carry, (tl, cl) = one_epoch(carry, None)
                    losses = jax.lax.dynamic_update_slice(
                        losses, jnp.stack([tl, cl])[None, :], (epoch_idx, 0))
                    return carry, losses

                return jax.lax.while_loop(cond, body, (carry, losses0))

            self._chunk_cache[full_key] = jax.jit(
                train_full, static_argnames=("max_epochs", "stop_after"))
        train_chunk = self._chunk_cache[chunk_key]
        train_full = self._chunk_cache[full_key]

        history = {"loss": [], "val_loss": []}
        # fallback if no epoch ever reaches a finite monitored loss: keep
        # the INPUT stack (the trained params are NaN in that case)
        params_in = params
        monitor = "val_loss" if validation else "loss"
        key = jax.random.key(int(rng.integers(2**31 - 1)))
        lr = learning_rate
        plateau = _PlateauLR(lr, factor=0.2, patience=patience,
                             threshold=1e-4, min_lr=1e-6)

        stop_after = int(1.5 * patience)
        if epoch_chunk == "auto":
            chunk = max(1, min(max(stop_after // 2, 1), 25))
        else:
            chunk = max(1, int(epoch_chunk))
        chunk = min(chunk, epochs)

        carry = (params, opt_state, key, params,
                 jnp.asarray(np.inf, jnp.float32), jnp.asarray(0, jnp.int32),
                 jnp.asarray(0, jnp.int32), x_train, w_train, x_val, w_val,
                 jnp.asarray(noise_scale, jnp.float32),
                 jnp.asarray(n_train_real, jnp.float32),
                 jnp.asarray(n_val_real, jnp.float32))
        if not annealing:
            # one device call for the entire fit (see train_full above)
            carry, losses = train_full(carry, epochs, stop_after)
            n_done = int(carry[6])
            losses = np.asarray(losses[:n_done], dtype=np.float64)
            history["loss"] = losses[:, 0].tolist()
            if validation:
                history["val_loss"] = losses[:, 1].tolist()
            if verbose > 0:
                print(f"Trained {n_done} epochs; best {monitor} "
                      f"{float(carry[4]):.3f} at epoch {int(carry[5])}")
            best_params, best_loss = carry[3], carry[4]
            ok = np.isfinite(float(best_loss))
            stack = best_params if ok else params_in
            self.params = {"pre": jax.device_put(pre if ok else pre_prev),
                           "stack": stack}
            return history

        epochs_done = 0
        while epochs_done < epochs:
            # constant chunk length -> one compiled program per shape
            # bucket (may overshoot `epochs` by < chunk; best-params
            # tracking makes the extra epochs harmless)
            length = chunk
            carry, (tl, cl) = train_chunk(carry, length)
            tl = np.asarray(tl, dtype=np.float64)
            cl = np.asarray(cl, dtype=np.float64)
            history["loss"].extend(tl.tolist())
            if validation:
                history["val_loss"].extend(cl.tolist())
            epochs_done += length

            if verbose > 1:
                print(f"Epoch {epochs_done}/{epochs}, loss {tl[-1]:.3f}"
                      + (f", val {cl[-1]:.3f}" if validation else ""))

            if annealing:
                for v in cl:
                    new_lr = plateau.step(float(v))
                if new_lr != lr:
                    lr = new_lr
                    carry[1].hyperparams["lr"] = jnp.asarray(lr)

            best_idx = int(carry[5])
            if epochs_done - 1 - best_idx >= stop_after:
                if verbose > 0:
                    print(f"Finished early after {best_idx} epochs; "
                          f"best {monitor} {float(carry[4]):.3f}")
                break

        best_params, best_loss = carry[3], carry[4]
        ok = np.isfinite(float(best_loss))
        stack = best_params if ok else params_in
        self.params = {"pre": jax.device_put(pre if ok else pre_prev),
                       "stack": stack}
        return history


class _PlateauLR:
    """ReduceLROnPlateau: factor decay after `patience` stale epochs
    (absolute threshold), floored at min_lr. Mirrors the torch scheduler
    configured at reference flow.py:274-281."""

    def __init__(self, lr, factor=0.2, patience=20, threshold=1e-4, min_lr=1e-6):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = np.inf
        self.stale = 0

    def step(self, value):
        if value < self.best - self.threshold:
            self.best = value
            self.stale = 0
        else:
            self.stale += 1
            if self.stale > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.stale = 0
        return self.lr
