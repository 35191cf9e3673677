"""Candidate-scoring decoders: cross-attention, dot-product, weighted dot.

All decoders map (candidate embeddings ``o`` [B,T,d], candidate mask,
encoded profile ``p`` [B,L,d], profile mask) → per-candidate probability
[B, T].

Contracts:

* ``ca`` — CrossAttentionBlock (``src/carca.py:322-349``): candidates (Q)
  attend over the encoded profile (K, V) with **causal offset −1 during
  training** (target slot t attends profile positions < t; ``:339``) and no
  causal mask at eval; optional residual ``s + o``; Linear(d→1) + sigmoid.
  Divergence from the reference: we squeeze only the last axis — the
  reference's ``y.squeeze()`` (``:346``) also squeezes a size-1 batch dim,
  which crashes its own metric code at B=1.
* ``dot`` — DotProduct (``src/carca.py:352-365``): train scores Σ(p⊙o) per
  aligned position; eval scores the **last** profile state against every
  candidate (``p[:, -1:, :]``); sigmoid.
* ``wdot`` — WeightedDotProduct (``src/carca.py:368-395``): the reference
  builds W[i,j] = γ^j (tril) and computes Σ_j p'[b,i,j]·W[i,j] where
  p' = p.unsqueeze(2).repeat — which broadcasts the **i-th** state across j,
  so the op reduces exactly to a per-position scalar scale
  p[b,i] · Σ_{j≤i} γ^j. We implement that closed form (identical output, no
  [B,L,L,d] materialization). Optional L2-normalize → cosine mapped to [0,1]
  by (y+1)/2, else sigmoid.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from carca_tpu.config import ModelConfig
from carca_tpu.models import attention, layers

Params = Dict[str, jnp.ndarray]


def decoder_init(key: jax.Array, cfg: ModelConfig) -> Params:
    if cfg.decoder == "ca":
        k_attn, k_ffn = jax.random.split(key)
        return {
            "attn": attention.mha_init(k_attn, cfg.d),
            "ffn": layers.dense_init(k_ffn, cfg.d, 1),
        }
    # dot / wdot are parameter-free
    return {}


def decoder_apply(
    params: Params,
    cfg: ModelConfig,
    o: jnp.ndarray,
    o_mask: jnp.ndarray,
    p: jnp.ndarray,
    p_mask: jnp.ndarray,
    *,
    train: bool,
    rng: Optional[jax.Array],
    return_logits: bool = False,
) -> jnp.ndarray:
    """``return_logits=True`` skips the probability mapping (sigmoid, or
    the wdot-cosine affine) and returns the raw per-candidate score — the
    sampled-softmax objective (``TrainConfig.loss="softmax"``) needs
    logits, and probabilities would double-squash them. No reference
    counterpart (its loss consumes probabilities only,
    ``src/carca.py:437-444``)."""
    kind = cfg.decoder
    if kind == "ca":
        causal = -1 if train else None  # src/carca.py:339
        s = attention.mha_apply(
            params["attn"], o, p, p, q_mask=o_mask, k_mask=p_mask,
            n_heads=cfg.n_heads, causal=causal, dropout_rate=cfg.dropout,
            train=train, rng=rng,
            compute_dtype=cfg.compute_dtype,
        )
        if cfg.residual_ca:
            s = s + o
        y = layers.dense(params["ffn"], s, jnp.dtype(cfg.compute_dtype))
        y = y[..., 0].astype(jnp.float32)
        return y if return_logits else jax.nn.sigmoid(y)

    if kind == "dot":
        if train:
            y = jnp.sum(p * o, axis=-1)  # aligned positions (src/carca.py:360)
        else:
            y = jnp.sum(p[:, -1:, :] * o, axis=-1)  # last state vs all (:362)
        y = y.astype(jnp.float32)
        return y if return_logits else jax.nn.sigmoid(y)

    if kind == "wdot":
        L = p.shape[1]
        # closed form of src/carca.py:373-379: scale_i = Σ_{j≤i} γ^j
        scale = jnp.cumsum(cfg.gamma ** jnp.arange(L, dtype=jnp.float32))
        pw = p * scale[None, :, None]
        ow = o
        if cfg.l2_norm:
            # x·rsqrt(Σx²+eps), NOT x/max(‖x‖, eps): the norm's own gradient
            # at an exactly-zero vector (pad candidates) is 0/0 = NaN, and
            # 0·NaN poisons the whole backward pass — torch's F.normalize
            # (src/carca.py:381-384) takes the eps sub-gradient instead, so
            # the reference never sees this. rsqrt's gradient is finite at 0
            # and values match to f32 rounding for any non-degenerate vector.
            def _l2n(x):
                return x * jax.lax.rsqrt(
                    jnp.sum(jnp.square(x), axis=-1, keepdims=True) + 1e-12)
            pw = _l2n(pw)
            ow = _l2n(ow)
        if train:
            y = jnp.sum(pw * ow, axis=-1)
        else:
            y = jnp.sum(pw[:, -1:, :] * ow, axis=-1)
        y = y.astype(jnp.float32)
        if return_logits:
            return y  # wdot+l2_norm: the "logit" is the raw cosine
        if cfg.l2_norm:
            return (y + 1.0) / 2.0  # cosine → [0, 1] (src/carca.py:391)
        return jax.nn.sigmoid(y)

    raise ValueError(f"unknown decoder kind {kind!r}")
