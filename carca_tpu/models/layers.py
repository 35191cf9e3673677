"""Primitive layers as pure init/apply function pairs.

Params are plain dict pytrees (jit/pjit/shard_map friendly; trivially
checkpointable). Weights are stored float32; matmuls optionally run in a
lower compute dtype (bfloat16 on the MXU) with float32 accumulation.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from carca_tpu.utils.initializers import xavier_uniform

Params = Dict[str, jnp.ndarray]


def dense_init(key: jax.Array, d_in: int, d_out: int) -> Params:
    """Linear layer: xavier-uniform weight, zero bias
    (reference init scheme, e.g. ``src/carca.py:220-226``)."""
    return {
        "w": xavier_uniform(key, (d_in, d_out)),
        "b": jnp.zeros((d_out,), jnp.float32),
    }


def dense(params: Params, x: jnp.ndarray, compute_dtype=jnp.float32) -> jnp.ndarray:
    w = params["w"].astype(compute_dtype)
    y = jnp.dot(x.astype(compute_dtype), w, preferred_element_type=jnp.float32)
    return y + params["b"]


def layer_norm_init(d: int) -> Params:
    return {"scale": jnp.ones((d,), jnp.float32), "bias": jnp.zeros((d,), jnp.float32)}


def layer_norm(params: Params, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """LayerNorm over the last axis, torch semantics (biased variance,
    eps inside the sqrt; ``nn.LayerNorm`` defaults used at
    ``src/carca.py:279,283,408``). Computed in float32."""
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mu), axis=-1, keepdims=True)
    y = (x32 - mu) * jax.lax.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def dropout(rng: Optional[jax.Array], x: jnp.ndarray, rate: float, train: bool) -> jnp.ndarray:
    """Inverted dropout (torch ``nn.Dropout`` semantics: scale by 1/(1-p) at
    train, identity at eval)."""
    if not train or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout requires an rng key when train=True and rate>0")
    keep = 1.0 - rate
    # a SHAPED draw: a flat draw + reshape can cost a physical layout copy
    # of the random stream at these call sites (which side pays depends on
    # the PRNG and the backend — measure per site before changing it)
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


def leaky_relu(x: jnp.ndarray, negative_slope: float = 0.01) -> jnp.ndarray:
    """torch ``nn.LeakyReLU()`` default slope (``src/carca.py:285``)."""
    return jnp.where(x >= 0, x, negative_slope * x)
