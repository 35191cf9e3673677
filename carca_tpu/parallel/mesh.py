"""Device mesh construction and sharding rules.

The framework uses one global mesh with a ``data`` axis (batch / DP) and an
optional ``model`` axis (row-sharded embedding tables). All sharding is
expressed as ``NamedSharding`` over this mesh; XLA SPMD inserts the
collectives (gradient ``psum`` over ``data``, lookup ``psum`` over
``model``), which run over NVLink through NCCL. There is no hand-written
transport layer (the reference has none, SURVEY.md §2.3). Every card of a
host reaches every other at the same rate, so the mesh shape follows the
algorithm alone.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_DISTRIBUTED_ENV = {"coordinator_address": "JAX_COORDINATOR_ADDRESS",
                    "num_processes": "JAX_NUM_PROCESSES",
                    "process_id": "JAX_PROCESS_ID"}


def initialize_distributed(**kw) -> None:
    """Multi-process init; a no-op for a single process. Call once before
    any JAX computation.

    A multi-process run names its cluster explicitly — keyword arguments,
    or ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` (e.g. ``localhost:<port>``, 2, 0). With neither,
    the process runs alone and nothing is initialized (no coordinator to
    wait for, so nothing can hang). With either, any init failure raises
    — otherwise every process would silently train the full workload on
    its own and race on the checkpoint directory."""
    if jax.distributed.is_initialized():
        return
    for name, var in _DISTRIBUTED_ENV.items():
        if name not in kw and os.environ.get(var):
            value = os.environ[var]
            kw[name] = value if name == "coordinator_address" else int(value)
    if kw:
        jax.distributed.initialize(**kw)


def make_mesh(
    shape: Tuple[int, ...] = (),
    axes: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the global mesh. ``shape=()`` → all devices on the first axis.
    Devices are laid out in order: the cards of a host are joined all to
    all, so no placement is better than another."""
    devices = list(devices if devices is not None else jax.devices())
    if not shape:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(np.asarray(devices).reshape(shape), axes)


def _is_table_path(path) -> bool:
    """A leaf is a shardable table iff its pytree path goes through the
    embedding's ``items`` table (mirrored inside optimizer state by optax)."""
    for p in path:
        if getattr(p, "key", None) == "items":
            return True
    return False


def param_shardings(tree, mesh: Mesh, shard_embeddings: bool = False):
    """Sharding pytree for params / TrainState / optimizer state.

    Embedding tables (and their Adam moments, which share the tree path) are
    row-sharded ``P('model', None)`` when requested; everything else is
    replicated. Works on concrete pytrees and on ``jax.eval_shape`` output.
    """
    has_model = shard_embeddings and "model" in mesh.axis_names

    def rule(path, leaf):
        if has_model and _is_table_path(path) and getattr(leaf, "ndim", 0) == 2:
            return NamedSharding(mesh, P("model", None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, tree)


def batch_shardings(batch, mesh: Mesh):
    """Shard every batch array over ``data`` on its leading dim."""
    def rule(leaf):
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*(("data",) + (None,) * (ndim - 1))))
    return jax.tree_util.tree_map(rule, batch)


def table_sharding(mesh: Mesh, shard_embeddings: bool = False) -> NamedSharding:
    if shard_embeddings and "model" in mesh.axis_names:
        return NamedSharding(mesh, P("model", None))
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """device_put a host batch with data-parallel shardings (fixed shapes →
    one transfer per array, no per-device slicing on the host)."""
    return jax.device_put(batch, batch_shardings(batch, mesh))


def put_if_multiprocess(tree, shardings):
    """Global-ize host/local arrays before a jit with non-trivial
    ``in_shardings`` — on a multi-host pod, jit REJECTS raw numpy /
    process-local arrays for sharded specs ("Passing non-trivial shardings
    for numpy inputs is not allowed"); ``device_put`` builds the global
    array from the (identical-per-process) host value. Single-process runs
    skip it: jit's own implicit transfer is equivalent and this avoids a
    second dispatch on the hot path."""
    if jax.process_count() == 1:
        return tree
    return jax.device_put(tree, shardings)


def prepare_state_for_mesh(state, mesh: Mesh, tx, sparse_items: bool = False):
    """Pad embedding tables to row-shard evenly over ``model`` and rebuild
    the optimizer state to match (split dense/sparse structure when the
    lazy item-table Adam is on). Call once before training starts (resume
    checkpoints then carry padded shapes already)."""
    if mesh.shape.get("model", 1) == 1:
        return state

    def pad(path, leaf):
        if _is_table_path(path) and getattr(leaf, "ndim", 0) == 2:
            return jax.numpy.asarray(pad_table_rows(leaf, mesh))
        return leaf

    params = jax.tree_util.tree_map_with_path(pad, state.params)
    if sparse_items:
        from carca_tpu.train import sparse_adam as sa
        opt_state = {"dense": tx.init(sa.without_items(params)),
                     "items": sa.init_state(params["embed"]["items"])}
    else:
        opt_state = tx.init(params)
    return state.replace(params=params, opt_state=opt_state)


def pad_table_rows(table, mesh: Mesh):
    """Pad a table's row count to a multiple of the ``model`` axis size so it
    row-shards evenly; pad rows are never indexed (ids < n_items). Works on
    numpy and device (jnp) tables — device tables stay on device."""
    n = mesh.shape.get("model", 1)
    rows = table.shape[0]
    pad = (-rows) % n
    if pad:
        xp = np if isinstance(table, np.ndarray) else jax.numpy
        table = xp.concatenate(
            [table, xp.zeros((pad,) + table.shape[1:], table.dtype)], axis=0)
    return table
