"""Lane-packed embedding tables.

A packed table stores ``p = 128 // d`` logical rows per physical row,

    packed[r] = concat(table[r*p], ..., table[r*p + p - 1])   # [⌈n/p⌉, p·d]

i.e. exactly ``table.reshape(⌈n/p⌉, p·d)`` after padding ``n`` up to a
multiple of ``p``. Lookup gathers the physical row then selects the d-wide
slice; autodiff turns that into a scatter-add over the packed rows.
Unpacking is a reshape.

Packing exists for memory layouts that pad every row to 128 lanes (the
layout the system was first built for): there it halves a ``[n, 64]``
table's footprint and that of its Adam moments. The GPU stores a
``[n, 64]`` table densely, so packing saves nothing there; ``"auto"``
therefore never packs, and ``True`` packs on request (a packed-versus-plain
measurement on the GPU is an open ROADMAP item).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LANES = 128


def pack_factor(width: int, n_rows: int = 0, flag="auto") -> int:
    """Physical rows-per-row for a [n_rows, width] table.

    ``flag``: True → pack whenever the width divides the 128-lane row;
    False or "auto" → never (dense layouts gain nothing, module docstring).
    ``n_rows`` is accepted for call-site symmetry.
    """
    if flag is not True or width >= LANES or LANES % width:
        return 1
    return LANES // width


def pack_rows(table, p: int):
    """[n, w] → [⌈n/p⌉, p·w] (rows padded with zeros). numpy or jnp."""
    if p == 1:
        return table
    n, w = table.shape
    pad = (-n) % p
    xp = np if isinstance(table, np.ndarray) else jnp
    if pad:
        table = xp.concatenate(
            [table, xp.zeros((pad, w), table.dtype)], axis=0)
    return table.reshape(-1, p * w)


def unpack_rows(packed, width: int):
    """Inverse of ``pack_rows`` (keeps the zero pad rows at the end)."""
    return packed.reshape(-1, width)


def lookup_maybe_packed(lookup, table, ids, width: int):
    """Gather ``width``-wide rows by id from a packed or unpacked table.

    ``lookup(table, row_ids)`` performs the physical-row gather (plain
    ``jnp.take`` or the shard_map row-sharded collective) — packing composes
    with row sharding because packed rows are still just rows.
    """
    if table.shape[-1] == width:
        return lookup(table, ids)
    p = table.shape[-1] // width
    rows = lookup(table, ids // p)  # [..., p·w]
    rows = rows.reshape(ids.shape + (p, width))
    sub = (ids % p)[..., None, None]
    return jnp.take_along_axis(rows, sub, axis=-2)[..., 0, :]
