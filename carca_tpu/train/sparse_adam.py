"""Lazy (row-sparse) Adam for huge embedding tables.

A train step touches ~3·B·L distinct item rows (~38k at B=256, L=50) of a
10M-row table, but dense Adam reads and writes the full table plus both
moment tables every step — ~13 GB of device-memory traffic for the
`synthetic10m` preset, several times the work of the rest of the step.
The reference has the same dense-Adam-over-`nn.Embedding`
structure (`scripts/training.py:174`), it just never meets a table big
enough to notice.

The sparse path removes the dense traffic entirely:

* the loss is differentiated w.r.t. a **gathered sub-table** of the
  batch's unique physical rows (the model's pluggable ``lookup`` resolves
  ids inside the sub-table by binary search), so autograd produces a
  ``[U, width]`` gradient — no ``[R, width]`` dense gradient is ever
  materialized;
* Adam's moments stay dense in HBM (capacity is unchanged) but only the
  touched rows are gathered, updated, and scattered back.

Semantics vs dense Adam (torch semantics, the reference's optimizer):
identical for every row whose moments are zero or which is touched every
step — in particular the FIRST update of any row is bit-equal. A row
touched at step ``t₁`` and again at ``t₂`` skips the moment decay of the
untouched gap (``b1^(t₂-t₁-1)``) — the standard "lazy Adam" trade
(TensorFlow ``LazyAdamOptimizer``, torch ``SparseAdam``), applied per-row.
Classic-L2 weight decay likewise applies to touched rows only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]


class SubTable(NamedTuple):
    """Marker pytree for the gathered unique-rows sub-table.

    The model's pluggable ``lookup`` sees both the attrs catalog and the
    sub-table; routing between them must be by IDENTITY, not by shape — a
    same-shaped array flowing through the lookup would silently misroute
    (an old shape dispatch needed a ``cap += 1`` collision bump plus an
    assert). NamedTuples are pytrees,
    so the wrapper survives jit/grad transparently; ``shape`` delegates so
    ``lookup_maybe_packed``'s packed-width dispatch keeps working.
    """

    rows: jnp.ndarray

    @property
    def shape(self):
        return self.rows.shape


def resolve(cfg) -> bool:
    """THE sparse-items-Adam decision for a Config — shared by ``fit`` and
    every checkpoint-template builder (carca-serve restore), because the
    flag changes the opt-state tree structure on disk.

    "auto" turns it on for ≥1M-item tables at B ≤ 1024: the unique-sort
    and row traffic grow with B while the dense sweep they replace is
    constant, so large batches favour dense Adam. The crossover has not
    been measured on the GPU yet.
    """
    import numpy as np

    tc, dc, mc = cfg.train, cfg.data, cfg.model
    has_table = mc.embedding in ("all", "id", "mlpid")
    if tc.sparse_items_adam is True:
        if not dc.device_pipeline:
            raise ValueError("sparse_items_adam requires device_pipeline=true")
        if not has_table:
            raise ValueError(
                f"sparse_items_adam needs an item table; embedding="
                f"{mc.embedding!r} has none (attr/attrctx are id-free)")
        return True
    return (tc.sparse_items_adam == "auto"
            and dc.device_pipeline
            and not (tc.mesh_shape and int(np.prod(tc.mesh_shape)) > 1)
            and has_table
            and mc.n_items >= 1_000_000
            and tc.batch_size <= 1024)


def touched_physical_rows(batch: Dict[str, jnp.ndarray], pack: int,
                          n_phys_rows: int, cap: int
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(unique physical rows [cap], position map [n_phys_rows]) for a
    train batch's profile + target ids.

    Dedup uses ``jnp.unique`` (sort-based); the position map then inverts
    row→slot with one dense [R] int32 scatter of the *unique* rows — no
    duplicate-index serialization (duplicate-heavy scatters serialize),
    and each lookup site
    resolves ids with a single gather instead of a log₂(cap)-step binary
    search. Fill slots hold ``n_phys_rows`` (out of range; scatters drop
    them)."""
    ids = jnp.concatenate([batch["p_x"].ravel(), batch["o_x"].ravel()])
    phys = ids // pack if pack > 1 else ids
    uphys = jnp.unique(phys, size=cap, fill_value=n_phys_rows)
    posmap = jnp.zeros((n_phys_rows,), jnp.int32).at[uphys].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop")
    return uphys, posmap


def make_sub_lookup(posmap: jnp.ndarray,
                    base_lookup: Callable | None = None) -> Callable:
    """A ``lookup(table, rows)`` for ``embedding_apply`` that resolves
    physical rows inside the gathered sub-table via the position map when
    the table IS the sub-table (identified by its ``SubTable`` wrapper —
    the full attrs catalog flows through the same lookup and must route
    through ``base_lookup``, e.g. the shard_map row-sharded gather on a
    mesh). ``embedding_apply``'s packed path already divides ids by the
    pack factor before calling lookup, so ``rows`` are physical."""

    def lookup(table, rows):
        if isinstance(table, SubTable):
            return table.rows[posmap[rows]]
        if base_lookup is not None:
            return base_lookup(table, rows)
        return jnp.take(table, rows, axis=0)

    return lookup


def without_items(params: Params) -> Params:
    """The params tree minus the item table (the dense optimizer's view)."""
    emb = dict(params["embed"])
    emb.pop("items", None)
    return dict(params, embed=emb)


def with_items(params: Params, items: jnp.ndarray) -> Params:
    return dict(params, embed=dict(params["embed"], items=items))


def init_state(table: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Moments live interleaved in ONE ``[R, 2W]`` array (mu ‖ nu per
    row): their gather/scatter pairs then fuse into one memory op each —
    row scatters are bound by per-row latency more than by row width, so
    3 scatters → 2 saves one whole scatter per step."""
    r, w = table.shape
    return {
        "munu": jnp.zeros((r, 2 * w), table.dtype),
        "count": jnp.zeros((), jnp.int32),
    }


def apply_rows_update(
    table: jnp.ndarray,
    sstate: Dict[str, jnp.ndarray],
    uphys: jnp.ndarray,
    g_rows: jnp.ndarray,
    sub_rows: jnp.ndarray,
    *,
    lr: jnp.ndarray,
    b1: float,
    b2: float,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """One Adam step restricted to rows ``uphys``; matches optax's
    ``add_decayed_weights → scale_by_adam → scale(−lr)`` chain elementwise
    on those rows (bias correction by the global step count)."""
    count = sstate["count"] + 1
    if weight_decay:
        g_rows = g_rows + weight_decay * sub_rows
    w = g_rows.shape[-1]
    munu = sstate["munu"].at[uphys].get(mode="fill", fill_value=0.0)
    mu_rows = b1 * munu[:, :w] + (1.0 - b1) * g_rows
    nu_rows = b2 * munu[:, w:] + (1.0 - b2) * jnp.square(g_rows)
    c = count.astype(jnp.float32)
    mu_hat = mu_rows / (1.0 - jnp.power(b1, c))
    nu_hat = nu_rows / (1.0 - jnp.power(b2, c))
    delta = (-lr) * mu_hat / (jnp.sqrt(nu_hat) + eps)
    table = table.at[uphys].add(delta.astype(table.dtype), mode="drop")
    return table, {
        "munu": sstate["munu"].at[uphys].set(
            jnp.concatenate([mu_rows, nu_rows], axis=-1), mode="drop"),
        "count": count,
    }


def lr_at(tc, count: jnp.ndarray) -> jnp.ndarray:
    """The step's learning rate under TrainConfig's schedule (the SAME
    ``make_schedule`` the dense optax chain uses, evaluated at the sparse
    path's own step count)."""
    from carca_tpu.train.state import make_schedule

    sched = make_schedule(tc)
    if sched is None:
        return jnp.asarray(tc.lr, jnp.float32)
    return jnp.asarray(sched(count), jnp.float32)
