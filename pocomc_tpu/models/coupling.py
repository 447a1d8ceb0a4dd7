"""Coupling-layer spline flows: one MLP pass in BOTH directions.

An addition beyond the reference's menu (which is autoregressive
only — /root/reference/pocomc/flow.py:54-86): the masked-autoregressive
inverse needs d sequential passes (a lax.scan in models/flow.py), which is
the hot op of the t-pCN sweep. RealNVP-style coupling layers (Dinh et al.
2017) with rational-quadratic splines (Durkan et al. 2019) invert in ONE
pass, trading some per-transform expressiveness (recovered by using more
transforms) for an inverse that is as cheap as the forward.

Architectures: 'nsfc6' / 'nsfc12' (6 / 12 coupling transforms, 8-bin RQS,
alternating halves), exposed through the same Flow class.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import transforms as tr


def make_coupling_masks(n_dim: int, n_transforms: int):
    """Alternating binary masks: transform t conditions on `mask==1` dims
    and transforms the `mask==0` dims."""
    masks = []
    for t in range(n_transforms):
        m = np.zeros(n_dim, dtype=bool)
        if t % 2 == 0:
            m[: (n_dim + 1) // 2] = True
        else:
            m[(n_dim + 1) // 2:] = True
        masks.append(m)
    return masks


def init_coupling(rng: np.random.Generator, n_dim: int, hidden_sizes,
                  n_params: int, cond_mask: np.ndarray):
    """Plain MLP from the conditioning dims to the transformed dims'
    parameter block; zero-init output layer for an identity start.
    Host-numpy init (see models/made.py init_made)."""
    n_cond = int(cond_mask.sum())
    n_out = int((~cond_mask).sum()) * n_params
    sizes = [max(n_cond, 1)] + list(hidden_sizes) + [n_out]
    params = []
    for l in range(len(sizes) - 1):
        fan_in, fan_out = sizes[l], sizes[l + 1]
        if l == len(sizes) - 2:
            w = np.zeros((fan_in, fan_out), np.float32)
        else:
            w = (np.sqrt(2.0 / fan_in)
                 * rng.standard_normal((fan_in, fan_out))).astype(np.float32)
        params.append({"w": w, "b": np.zeros(fan_out, np.float32)})
    return params


def apply_coupling_net(params, x_cond):
    """(n, n_cond) -> (n, n_trans, n_params)."""
    h = x_cond @ params[0]["w"] + params[0]["b"]
    for l in range(1, len(params) - 1):
        y = jax.nn.relu(h) @ params[l]["w"] + params[l]["b"]
        if params[l]["w"].shape[0] == params[l]["w"].shape[1]:
            h = h + y
        else:
            h = y
    out = jax.nn.relu(h) @ params[-1]["w"] + params[-1]["b"]
    return out


def coupling_forward(params, cond_mask, x, bins: int):
    """One coupling transform, data -> latent. Returns (z, ladj_rows)."""
    cond_idx = jnp.asarray(np.nonzero(cond_mask)[0])
    trans_idx = jnp.asarray(np.nonzero(~cond_mask)[0])
    xc = x[:, cond_idx]
    xt = x[:, trans_idx]
    p = apply_coupling_net(params, xc).reshape(x.shape[0], trans_idx.shape[0], -1)
    zt, ladj = tr.rqs_forward(xt, p, bins)
    z = x.at[:, trans_idx].set(zt)
    return z, jnp.sum(ladj, axis=-1)


def coupling_inverse(params, cond_mask, z, bins: int):
    """One coupling transform, latent -> data, ONE pass. (x, ladj_rows)."""
    cond_idx = jnp.asarray(np.nonzero(cond_mask)[0])
    trans_idx = jnp.asarray(np.nonzero(~cond_mask)[0])
    zc = z[:, cond_idx]          # conditioning dims pass through unchanged
    zt = z[:, trans_idx]
    p = apply_coupling_net(params, zc).reshape(z.shape[0], trans_idx.shape[0], -1)
    xt, ladj = tr.rqs_inverse(zt, p, bins)
    x = z.at[:, trans_idx].set(xt)
    return x, jnp.sum(ladj, axis=-1)
