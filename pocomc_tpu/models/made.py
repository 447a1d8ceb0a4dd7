"""MADE: masked autoregressive MLP (Germain et al. 2015), pure JAX.

This replaces the libtorch/zuko MaskedMLP used by the reference flows
(/root/reference/pocomc/flow.py:54-86 configures zuko MAF/NSF with
hidden_features=[n_hidden]*3, residual=True, where n_hidden =
max(next_pow2(3*n_dim), 32) — flow.py:49-52). Capacity here matches that.

Design notes:
  - masks are static constants baked into the jitted program; the masked
    matmul is `x @ (w * mask)`, which XLA compiles as one matmul with an
    elementwise pre-multiply,
  - residual connections on the equal-width hidden layers preserve the
    autoregressive degree structure (identity keeps degrees),
  - the final layer is zero-initialized so every flow starts at the
    identity map, which stabilizes early SMC iterations.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def make_degrees(n_dim: int, order: np.ndarray, hidden_sizes: list[int]):
    """Degree vectors for input, hidden layers, and output.

    `order[i]` is the autoregressive rank (0-based) of input dim i. Inputs
    get degree rank+1; hidden units cycle through 1..max(1, d-1); outputs
    reuse the input degrees (strict inequality applied at the output mask).
    """
    in_deg = np.asarray(order) + 1  # 1..d
    degs = [in_deg]
    max_deg = max(1, n_dim - 1)
    for h in hidden_sizes:
        degs.append((np.arange(h) % max_deg) + 1)
    return degs


def make_masks(degs, n_dim: int, n_params: int):
    """Boolean connectivity masks per layer (hidden: >=, output: >)."""
    masks = []
    for l in range(1, len(degs)):
        masks.append((degs[l][:, None] >= degs[l - 1][None, :]).astype(np.float32).T)
    out_deg = np.repeat(degs[0], n_params)  # output block layout: (d, n_params)
    masks.append((out_deg[:, None] > degs[-1][None, :]).astype(np.float32).T)
    return masks


def init_made(rng: np.random.Generator, n_dim: int, hidden_sizes: list[int],
              n_params: int, order: np.ndarray):
    """Initialize MADE parameters; returns (params_pytree, static_masks).

    Initialization runs in host numpy (a np.random.Generator, not a JAX
    key): eager per-layer jax.random calls would each dispatch a device
    op. The caller device_puts the finished pytree once.
    """
    degs = make_degrees(n_dim, order, hidden_sizes)
    masks = make_masks(degs, n_dim, n_params)
    sizes = [n_dim] + list(hidden_sizes) + [n_dim * n_params]

    params = []
    for l, m in enumerate(masks):
        fan_in, fan_out = sizes[l], sizes[l + 1]
        if l == len(masks) - 1:
            w = np.zeros((fan_in, fan_out), np.float32)  # identity start
        else:
            scale = np.sqrt(2.0 / fan_in)
            w = (scale * rng.standard_normal((fan_in, fan_out))).astype(np.float32)
        params.append({"w": w, "b": np.zeros(fan_out, np.float32)})
    return params, [np.asarray(m, np.float32) for m in masks]


def _hidden_stack(params, masks, x):
    """Shared hidden layers: (n, d) -> (n, h) pre-activation."""
    h = x @ (params[0]["w"] * masks[0]) + params[0]["b"]
    for l in range(1, len(params) - 1):
        y = jax.nn.relu(h)
        y = y @ (params[l]["w"] * masks[l]) + params[l]["b"]
        if params[l]["w"].shape[0] == params[l]["w"].shape[1]:
            h = h + y
        else:
            h = y
    return h


def apply_made(params, masks, x, n_dim: int, n_params: int):
    """Forward pass: (n, d) -> (n, d, n_params). Residual on equal-width
    hidden layers, ReLU activations."""
    h = _hidden_stack(params, masks, x)
    out = jax.nn.relu(h) @ (params[-1]["w"] * masks[-1]) + params[-1]["b"]
    return out.reshape(x.shape[0], n_dim, n_params)


def apply_made_dim(params, masks, x, dim, n_params: int):
    """MADE pass returning the parameter block of a SINGLE output dim
    (traced index): (n, d) -> (n, n_params).

    Used by the autoregressive inverse scan, where each step only needs
    one dimension's transform parameters — slicing the output layer to
    `n_params` columns cuts its matmul d-fold versus a full pass.
    """
    h = _hidden_stack(params, masks, x)
    w_out = params[-1]["w"]
    start = dim * n_params
    w = jax.lax.dynamic_slice(w_out, (0, start), (w_out.shape[0], n_params))
    m = jax.lax.dynamic_slice(masks[-1], (0, start), (w_out.shape[0], n_params))
    b = jax.lax.dynamic_slice(params[-1]["b"], (start,), (n_params,))
    return jax.nn.relu(h) @ (w * m) + b
