"""Multi-head attention with the reference's (nonstandard) exact semantics.

Behavioral contract (``src/carca.py:204-265``):

* Q/K/V projections with bias; **no output projection W_O**.
* Head split: the reference splits the feature dim into H chunks and stacks
  them along the batch dim (``src/carca.py:242-244``); mathematically
  identical to the standard [B, H, L, dh] layout used here.
* Pairwise mask = outer product q_mask ⊗ k_mask (``:246-248``), optionally
  lower-triangularized with offset ``causal`` (``tril(diagonal=causal)``,
  ``:250``): encoder uses causal=0, train-time cross-attention causal=−1,
  eval cross-attention None.
* Additive mask −(2³²−1) is added **before** dividing by √(d/H)
  (``baddbmm`` then scale, ``:253-254``) — i.e. logits = (QKᵀ + add)/scale.
* Post-softmax **re-mask**: weights ⊙ mask (``:256``) — fully-masked rows
  (softmax → uniform) are zeroed, so padded queries emit exactly 0.
* Dropout applied **to the attention weights** (``:258``), then ⊙ V.

Plain jnp, left to XLA: at CARCA's lengths (L ≤ 200, head dim 32) the
``[B, H, Lq, Lk]`` logits are small enough for XLA's fused softmax.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from carca_tpu.models import layers

Params = Dict[str, jnp.ndarray]

NEG_MASK = -(2.0**32) + 1.0  # src/carca.py:251


def mha_init(key: jax.Array, d: int) -> Params:
    kq, kk, kv = jax.random.split(key, 3)
    return {
        "wq": layers.dense_init(kq, d, d),
        "wk": layers.dense_init(kk, d, d),
        "wv": layers.dense_init(kv, d, d),
    }


def _split_heads(x: jnp.ndarray, n_heads: int) -> jnp.ndarray:
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads).transpose(0, 2, 1, 3)


def _merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    b, h, l, dh = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, l, h * dh)


def pair_mask(
    q_mask: jnp.ndarray, k_mask: jnp.ndarray, causal: Optional[int]
) -> jnp.ndarray:
    """[B, Lq, Lk] float mask: q_mask ⊗ k_mask, tril'd at offset ``causal``.

    ``causal`` semantics match ``torch.tril(diagonal=causal)``: keep entries
    with k_pos ≤ q_pos + causal (src/carca.py:250).
    """
    m = q_mask[:, :, None] * k_mask[:, None, :]
    if causal is not None:
        lq, lk = q_mask.shape[1], k_mask.shape[1]
        rows = jnp.arange(lq)[:, None]
        cols = jnp.arange(lk)[None, :]
        tri = (cols <= rows + causal).astype(m.dtype)
        m = m * tri[None]
    return m


def masked_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    q_mask: jnp.ndarray,
    k_mask: jnp.ndarray,
    *,
    n_heads: int,
    causal: Optional[int],
    scale: float,
    dropout_rate: float = 0.0,
    train: bool = True,
    rng: Optional[jax.Array] = None,
    compute_dtype=jnp.float32,
    return_w: bool = False,
):
    """THE reference attention math on post-projection tensors."""
    cd = jnp.dtype(compute_dtype)
    h = n_heads
    b, lq, d = q.shape
    lk = k.shape[1]
    dh = d // h

    m = pair_mask(q_mask, k_mask, causal)  # [B, Lq, Lk]
    add = jnp.where(m > 0, 0.0, NEG_MASK).astype(jnp.float32)

    qh = _split_heads(q.astype(cd), n_heads)
    kh = _split_heads(k.astype(cd), n_heads)
    vh = _split_heads(v.astype(cd), n_heads)

    # logits in fp32: (QKᵀ + add) / √(d/H)  — mask added pre-scale, as in
    # baddbmm at src/carca.py:253-254
    logits = jnp.einsum("bhqe,bhke->bhqk", qh, kh, preferred_element_type=jnp.float32)
    logits = (logits + add[:, None]) / scale

    w = jax.nn.softmax(logits, axis=-1)
    w = w * m[:, None]  # post-softmax re-mask (src/carca.py:256)

    wd = layers.dropout(rng, w, dropout_rate, train)  # dropout on weights (:258)
    out = jnp.einsum("bhqk,bhke->bhqe", wd.astype(cd), vh, preferred_element_type=jnp.float32)
    out = _merge_heads(out).astype(jnp.float32)
    if return_w:
        return w, out
    return out


def mha_apply(
    params: Params,
    query: jnp.ndarray,
    key: jnp.ndarray,
    value: jnp.ndarray,
    q_mask: jnp.ndarray,
    k_mask: jnp.ndarray,
    *,
    n_heads: int,
    causal: Optional[int],
    dropout_rate: float,
    train: bool,
    rng: Optional[jax.Array],
    compute_dtype=jnp.float32,
    return_w: bool = False,
):
    """query [B,Lq,d], key/value [B,Lk,d], masks [B,Lq]/[B,Lk] → [B,Lq,d]."""
    cd = jnp.dtype(compute_dtype)
    if train and dropout_rate > 0.0 and rng is None:
        raise ValueError("dropout requires an rng key when train=True and rate>0")
    q = layers.dense(params["wq"], query, cd)
    k = layers.dense(params["wk"], key, cd)
    v = layers.dense(params["wv"], value, cd)

    d = q.shape[-1]
    scale = (d / n_heads) ** 0.5

    # a stable name for the profiler: scripts/profile_step.py attributes
    # device time to the [B, H, Lq, Lk] part of the step by this scope
    with jax.named_scope("attention"):
        return masked_attention(
            q, k, v, q_mask, k_mask, n_heads=n_heads, causal=causal,
            scale=scale, dropout_rate=dropout_rate, train=train, rng=rng,
            compute_dtype=cd, return_w=return_w)
