"""Train state: a single pytree carrying everything needed to resume.

The reference checkpoints only a whole-module pickle of the best model
(``src/train.py:117-124``) — no optimizer state, no RNG, no resume. Here the
full state (params + optimizer moments + PRNG key + step) is one pytree,
checkpointable and restorable mid-run (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax

from carca_tpu.config import ModelConfig, TrainConfig
from carca_tpu.models.carca import carca_init


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Dict[str, Any]
    opt_state: Any
    rng: jax.Array
    step: jnp.ndarray  # scalar int32

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def decay_mask(params):
    """L2-decay every trainable leaf EXCEPT the constant sinusoidal table:
    ``pe`` is a registered *buffer* in the reference (src/carca.py:51-53)
    that torch's optimizer never touches, and its stop_gradient here means
    autograd gives it zero true gradient — an unmasked add_decayed_weights
    would inject l2_reg·pe as a fake gradient and erode the fixed table."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, _ in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        leaves.append("pe" not in keys)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def make_schedule(tc: TrainConfig):
    """The run's learning-rate schedule as a callable step→lr (None for a
    constant lr). Single source for both the dense optax chain and the
    sparse item-table Adam — they must never drift apart."""
    if tc.lr_schedule == "none" or tc.lr_decay_steps <= 0:
        return None
    if tc.lr_schedule == "cosine":
        return optax.cosine_decay_schedule(tc.lr, tc.lr_decay_steps,
                                           alpha=tc.lr_decay_rate)
    if tc.lr_schedule == "exponential":
        return optax.exponential_decay(tc.lr, tc.lr_decay_steps,
                                       tc.lr_decay_rate)
    raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")


def make_optimizer(tc: TrainConfig) -> optax.GradientTransformation:
    """torch.optim.Adam equivalence (``scripts/training.py:174``):
    betas=(beta1, beta2), eps=1e-8, and ``weight_decay`` added to the
    gradient **before** the moment updates (classic L2, not AdamW) — hence
    ``add_decayed_weights`` ahead of ``scale_by_adam``."""
    chain = []
    if tc.l2_reg > 0.0:
        chain.append(optax.add_decayed_weights(tc.l2_reg, mask=decay_mask))
    chain.append(optax.scale_by_adam(b1=tc.beta1, b2=tc.beta2, eps=1e-8))
    sched = make_schedule(tc)
    if sched is None:
        chain.append(optax.scale(-tc.lr))
    else:
        chain.append(optax.scale_by_learning_rate(sched))
    return optax.chain(*chain)


def create_train_state(
    rng: jax.Array, mc: ModelConfig, tc: TrainConfig,
    tx: optax.GradientTransformation | None = None,
    sparse_items: bool = False,
) -> TrainState:
    """``sparse_items`` splits the optimizer state: the dense optax chain
    covers everything except the item table, which gets the lazy row-Adam
    moments (train/sparse_adam.py). The step functions must be built with
    the same flag."""
    k_init, k_run = jax.random.split(rng)
    params = carca_init(k_init, mc)
    tx = tx or make_optimizer(tc)
    if sparse_items:
        from carca_tpu.train import sparse_adam
        opt_state = {
            "dense": tx.init(sparse_adam.without_items(params)),
            "items": sparse_adam.init_state(params["embed"]["items"]),
        }
    else:
        opt_state = tx.init(params)
    return TrainState(
        params=params,
        opt_state=opt_state,
        rng=k_run,
        step=jnp.zeros((), jnp.int32),
    )
