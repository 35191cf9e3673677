"""Device-resident dataset: batch assembly as index math on the card.

The reference's input pipeline ships dense per-example tensors from host
workers every step (``src/data.py:90-192`` + DataLoader). Host→device
transfers sit on the step's critical path. Here the packed CSR catalog
(items, contexts, offsets, leave-one-out window bounds) lives in device
memory once, and batches are *assembled inside the jitted step* from a
[B] vector of user rows — the only per-step host→device transfer.

Semantics match ``BatchBuilder`` (same window formulas, right-alignment,
negative-context inheritance, labels), except negatives may repeat within
an example (~S²/2n chance per row — see ``parallel.sampling``; the host
pipeline dedupes like the reference). Negative sampling uses the on-device
sampler; with ``reject_width > 0`` (the default policy in ``fit`` when
histories are short enough) it rejects against the user's **full history**
gathered from the HBM-resident CSR — the reference's exact protocol
(``src/data.py:77-87``). ``reject_width = 0`` falls back to rejecting
against the visible window + targets only, the documented approximation
for extreme history lengths (``DataConfig.exact_rejection``).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from carca_tpu.data.loaders import Catalog
from carca_tpu.data.windowing import valid_users, window_bounds
from carca_tpu.parallel.sampling import (device_sample_negatives,
                                         retries_for)


class DeviceDataset:
    """HBM-resident catalog + per-split window bounds."""

    def __init__(self, catalog: Catalog, seq_len: int, target_len: int,
                 test: bool = True):
        self.L = int(seq_len)
        self.T = int(target_len)
        self.n_items = catalog.n_items
        self.n_ctx = catalog.n_ctx
        lengths = np.diff(catalog.offsets)
        self._users = {
            m: valid_users(lengths, self.L, m, test)
            for m in ("train", "val", "test")
        }
        bounds = {m: window_bounds(lengths, self.L, m, test)
                  for m in ("train", "val", "test")}
        self.hist_max = int(lengths.max()) if len(lengths) else 0
        items = jnp.asarray(catalog.items, jnp.int32)
        ctx = jnp.asarray(catalog.ctx_vals, jnp.float32)
        self.arrays: Dict[str, jnp.ndarray] = {
            "items": items,
            "ctx": ctx,
            # item id (as an exact f32 VALUE) ‖ ctx, fused so batch assembly
            # does ONE row gather per window instead of two (row gathers
            # pay per row more than per byte).
            # Ids ride as float VALUES (exact for id < 2²⁴), NOT a bitcast:
            # ids bitcast to f32 are denormals, which hardware may flush to
            # zero on a relayout (seen on the first accelerator this ran
            # on: every gathered id read back 0)
            "offsets": jnp.asarray(catalog.offsets[:-1], jnp.int32),
            "hist_len": jnp.asarray(lengths, jnp.int32),
        }
        if catalog.n_items < 2**24:  # beyond 16.7M ids the f32 value is lossy
            self.arrays["evt_packed"] = jnp.concatenate(
                [items.astype(jnp.float32)[:, None], ctx], axis=1)
        for m, (s, e) in bounds.items():
            self.arrays[f"start_{m}"] = jnp.asarray(s, jnp.int32)
            self.arrays[f"end_{m}"] = jnp.asarray(e, jnp.int32)

    def users(self, mode: str) -> np.ndarray:
        return self._users[mode]


def _window_slots(arrays, mode: str, user_rows: jnp.ndarray, L: int,
                  n_slots: int):
    """Right-aligned window event indices (BatchBuilder._profile_slots).

    ``n_slots`` = L yields the profile window; L+1 extends it by one slot
    so the final event (the shift-by-one positives' last item) shares the
    same gather. Slot j covers event position ``e - L - 1 + j``.
    """
    rows = jnp.maximum(user_rows, 0)
    s = arrays[f"start_{mode}"][rows]
    e = arrays[f"end_{mode}"][rows]
    off = arrays["offsets"][rows]
    alive = (user_rows >= 0) & (e > s)
    j = jnp.arange(n_slots, dtype=jnp.int32)[None, :]
    pi = e[:, None] - L - 1 + j
    valid = (pi >= s[:, None]) & alive[:, None]
    p_evt = jnp.where(valid, off[:, None] + pi, 0)
    return p_evt, valid, alive, e, off


def _profile_slots(arrays, mode: str, user_rows: jnp.ndarray, L: int):
    return _window_slots(arrays, mode, user_rows, L, L)


def _history_rows(arrays, user_rows: jnp.ndarray, H: int) -> jnp.ndarray:
    """[B, H] of each user's FULL history item ids, 0-padded (H = the
    dataset's max history length, a static shape). The reference's sampler
    rejects against this whole set (``src/data.py:77-87``)."""
    rows = jnp.maximum(user_rows, 0)
    off = arrays["offsets"][rows]
    n = arrays["hist_len"][rows]
    j = jnp.arange(H, dtype=jnp.int32)[None, :]
    valid = (j < n[:, None]) & (user_rows >= 0)[:, None]
    idx = jnp.where(valid, off[:, None] + j, 0)
    return jnp.where(valid, arrays["items"][idx], 0)


def assemble_train(arrays, L: int, n_items: int, user_rows: jnp.ndarray,
                   rng: jax.Array, reject_width: int = 0,
                   neg_pop: bool = False,
                   n_neg: int = 1) -> Dict[str, jnp.ndarray]:
    """[B] user rows → train batch, entirely on device.

    The positive targets are the profile window shifted by one event
    (``src/data.py:112-121``), so one [B, L+1] window gather per table
    serves profile items, positives, and their contexts — TPU row gathers
    are the dominant assembly cost (measured ~4 ms/step at B=2048 with
    separate p/o/last gathers; halved by the shared window).

    ``n_neg`` (``TrainConfig.n_train_negatives``): negatives per positive.
    1 reproduces the reference layout (o arrays [B, 2L], src/data.py:
    122-130); K>1 widens them to [B, (1+K)L] group-major — all K·L
    negatives of a row are sampled jointly without replacement, every
    group inherits the positives' contexts (the :130 rule).
    """
    evt, validw, alive, _, _ = _window_slots(arrays, "train", user_rows, L,
                                             L + 1)
    if "evt_packed" in arrays:  # one fused gather (absent beyond 2²⁴ items)
        w = arrays["evt_packed"][evt]  # [B, L+1, 1+C]
        w_x = jnp.where(validw, w[..., 0].astype(jnp.int32), 0)
        w_c = w[..., 1:] * validw[..., None]  # [B, L+1, C]
    else:
        w_x = jnp.where(validw, arrays["items"][evt], 0)
        w_c = arrays["ctx"][evt] * validw[..., None]

    valid = validw[:, :L]
    p_x = w_x[:, :L]
    p_c = w_c[:, :L]
    # slot j's positive is window slot j+1; re-zero under the *profile*
    # validity (slot L is valid whenever the user is alive, since e > s)
    o_pos = jnp.where(valid, w_x[:, 1:], 0)
    o_pos_c = w_c[:, 1:] * valid[..., None]

    # fresh negatives per call. reject_width > 0 → reject against the
    # user's full history (the reference's exact protocol); else against
    # everything visible — the targets are the window shifted by one, so
    # visible = the whole [B, L+1] window (the sampler's all-pairs compare
    # cost is linear in the reject-set width)
    reject = (_history_rows(arrays, user_rows, reject_width)
              if reject_width > 0 else w_x)
    negs = device_sample_negatives(
        rng, reject, n_items, n_neg * L,
        retries_for(reject.shape[1], n_items, popularity=neg_pop),
        events=arrays["items"] if neg_pop else None)
    o_neg = jnp.where(jnp.tile(valid, (1, n_neg)), negs, 0)

    o_x = jnp.concatenate([o_pos, o_neg], axis=1)
    o_c = jnp.concatenate([o_pos_c] * (1 + n_neg), axis=1)  # src/data.py:130
    y = jnp.concatenate([valid.astype(jnp.float32),
                         jnp.zeros((valid.shape[0], n_neg * L),
                                   jnp.float32)], axis=1)
    return {"p_x": p_x, "p_c": p_c, "o_x": o_x, "o_c": o_c, "y_true": y,
            "n_valid": jnp.sum(alive.astype(jnp.int32))}


def assemble_eval(arrays, L: int, T: int, n_items: int, mode: str,
                  user_rows: jnp.ndarray, rng: jax.Array,
                  reject_width: int = 0) -> Dict[str, jnp.ndarray]:
    """[B] user rows → eval batch (1 held-out positive + T negatives)."""
    ctx = arrays["ctx"]
    p_evt, valid, alive, e, off = _profile_slots(arrays, mode, user_rows, L)

    one_out = jnp.where(alive, off + e - 1, 0)
    if "evt_packed" in arrays:
        # profile window + held-out positive in ONE fused row gather (see
        # ``evt_packed`` in DeviceDataset)
        w = arrays["evt_packed"][
            jnp.concatenate([p_evt, one_out[:, None]], axis=1)]
        w_x = w[..., 0].astype(jnp.int32)
        p_x = jnp.where(valid, w_x[:, :L], 0)
        p_c = w[:, :L, 1:] * valid[..., None]
        pos = jnp.where(alive, w_x[:, L], 0)
        pos_c = w[:, L, 1:] * alive[:, None]
    else:
        items = arrays["items"]
        p_x = jnp.where(valid, items[p_evt], 0)
        p_c = ctx[p_evt] * valid[..., None]
        pos = jnp.where(alive, items[one_out], 0)
        pos_c = ctx[one_out] * alive[:, None]

    visible = (_history_rows(arrays, user_rows, reject_width)
               if reject_width > 0
               else jnp.concatenate([p_x, pos[:, None]], axis=1))
    negs = device_sample_negatives(rng, visible, n_items, T,
                                   retries_for(visible.shape[1], n_items))
    negs = jnp.where(alive[:, None], negs, 0)

    o_x = jnp.concatenate([pos[:, None], negs], axis=1)
    o_c = jnp.broadcast_to(pos_c[:, None, :], (pos.shape[0], T + 1, ctx.shape[1]))
    o_c = o_c * (o_x > 0)[..., None]
    y = jnp.zeros((pos.shape[0], T + 1), jnp.float32)
    y = y.at[:, 0].set(alive.astype(jnp.float32))
    return {"p_x": p_x, "p_c": p_c, "o_x": o_x, "o_c": o_c.astype(jnp.float32),
            "y_true": y, "n_valid": jnp.sum(alive.astype(jnp.int32))}
