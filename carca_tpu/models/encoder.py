"""Profile self-attention encoder block.

Contract (``src/carca.py:272-318``):

* Pre-norm on the **query only**: ``q = LN1(x)``; K and V are the raw ``x``
  (``src/carca.py:298-299``).
* Self-attention with causal offset 0 (position t attends positions ≤ t).
* Optional residual ``s + q`` (note: +q, the normed query, not +x;
  ``src/carca.py:301-302``).
* ``LN2`` then a position-wise FFN of two k=1 convolutions (≡ dense layers)
  with LeakyReLU and dropout after each (``src/carca.py:304-313``).
* Optional residual ``f + s`` (``src/carca.py:315-316``).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from carca_tpu.config import ModelConfig
from carca_tpu.models import attention, layers

Params = Dict[str, jnp.ndarray]


def encoder_block_init(key: jax.Array, cfg: ModelConfig) -> Params:
    k_attn, k_f1, k_f2 = jax.random.split(key, 3)
    return {
        "norm1": layers.layer_norm_init(cfg.d),
        "attn": attention.mha_init(k_attn, cfg.d),
        "norm2": layers.layer_norm_init(cfg.d),
        "ffn1": layers.dense_init(k_f1, cfg.d, cfg.d),
        "ffn2": layers.dense_init(k_f2, cfg.d, cfg.d),
    }


def encoder_block_apply(
    params: Params,
    cfg: ModelConfig,
    x: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    train: bool,
    rng: Optional[jax.Array],
) -> jnp.ndarray:
    """x: [B, L, d], mask: [B, L] → [B, L, d]."""
    if rng is not None:
        r_attn, r_d1, r_d2 = jax.random.split(rng, 3)
    else:
        r_attn = r_d1 = r_d2 = None

    q = layers.layer_norm(params["norm1"], x)
    s = attention.mha_apply(
        params["attn"], q, x, x, q_mask=mask, k_mask=mask,
        n_heads=cfg.n_heads, causal=0, dropout_rate=cfg.dropout,
        train=train, rng=r_attn,
        compute_dtype=cfg.compute_dtype,
    )
    if cfg.residual_sa:
        s = s + q  # residual onto the normed query (src/carca.py:301-302)

    s = layers.layer_norm(params["norm2"], s)
    f = layers.dense(params["ffn1"], s, jnp.dtype(cfg.compute_dtype))
    f = layers.leaky_relu(f)
    f = layers.dropout(r_d1, f, cfg.dropout, train)
    f = layers.dense(params["ffn2"], f, jnp.dtype(cfg.compute_dtype))
    f = layers.dropout(r_d2, f, cfg.dropout, train)
    if cfg.residual_sa:
        f = f + s
    return f.astype(jnp.float32)
