"""Training / evaluation loops.

Reproduces the reference protocol (``src/train.py:56-152``):

* per epoch: iterate shuffled train batches; split the target block into
  positive/negative halves (``src/train.py:86-88``); forward with
  targets=[pos, neg]; masked BCE over the full [B, 2L] with
  ``get_mask(o_x)`` (``:92-93``); Adam step;
* evaluate on val each epoch (1 positive + 100 sampled negatives per user,
  HR@10/NDCG@10);
* keep the best-val-NDCG checkpoint only; early-stop after ``early_stop``
  non-improving epochs (``:117-137``); reload best and run the test split
  (``:141-149``);
* stdout prints + CSV logfile rows ``time;epoch;split;loss;HR;NDCG``
  (``:76-78,104-132``), hyperparameters dumped to args.json.

TPU-native: the step functions are jitted once (fixed shapes from the
fixed-size batch pipeline), batches arrive as ids+ctx only, attribute
vectors are gathered on device from the catalog table, and a ``Mesh`` can be
supplied to shard the batch over the ``data`` axis (pjit handles the
gradient all-reduce). Structured per-step metrics (examples/sec,
candidates/sec) land in ``metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from carca_tpu.config import Config
from carca_tpu.data.dataset import BatchBuilder, epoch_batches
from carca_tpu.data.prefetch import prefetch
from carca_tpu.data.loaders import Catalog
from carca_tpu.models.carca import carca_apply
from carca_tpu.models.losses import masked_bce, sampled_softmax
from carca_tpu.train.metrics import hr_ndcg_sums
from carca_tpu.train.state import TrainState, create_train_state, make_optimizer
from carca_tpu.utils.masking import get_mask



def attrs_dtype(mc):
    """HBM dtype for the attrs catalog: when the model computes in bf16
    the embedding layer casts attr rows to bf16 anyway, so storing the
    table f32 just makes XLA convert the WHOLE table once per dispatch
    (the [10M, 12] convert can't hoist across dispatches) and doubles its
    device-memory residency. Storing bf16
    is value-identical: one rounding either way."""
    return (jnp.bfloat16 if jnp.dtype(mc.compute_dtype) == jnp.bfloat16
            else jnp.float32)


def train_loss(mc, params, batch, step_rng, attrs_table, lookup=None,
               loss_kind: str = "bce", logq=None):
    """THE train-time loss, shared verbatim by every step variant (single-
    device, scanned, sharded, device-pipeline): target-group split
    (``src/train.py:86-88``; group count inferred from the batch width, so
    the reference's [pos, neg] pair and the K-negative layout share one
    path), forward, then the objective. Single definition = single-vs-
    multi-chip parity is structural, not copy-kept.

    ``loss_kind``: "bce" = masked BCE over every candidate slot with
    ``get_mask(o_x)`` (``src/train.py:92-93``, the reference objective);
    "softmax" = per-position sampled softmax over the groups with optional
    logQ correction (``models/losses.sampled_softmax`` — the retrieval-
    aligned objective, DESIGN §11c)."""
    L = mc.seq_len
    o_x, o_c = batch["o_x"], batch["o_c"]
    n_groups = o_x.shape[1] // L
    targets = [
        (o_x[:, i * L:(i + 1) * L], None, o_c[:, i * L:(i + 1) * L])
        for i in range(n_groups)
    ]
    kw = {} if lookup is None else {"lookup": lookup}
    y_pred = carca_apply(
        params, mc, (batch["p_x"], None, batch["p_c"]), targets,
        train=True, rng=step_rng, attrs_table=attrs_table,
        return_logits=loss_kind == "softmax", **kw)
    if loss_kind == "softmax":
        return sampled_softmax(y_pred, o_x, n_groups, logq=logq)
    return masked_bce(y_pred, batch["y_true"], get_mask(o_x))


def _loss_opts(tc, logq=None):
    """train_loss kwargs from TrainConfig (None -> reference defaults)."""
    if tc is None:
        return {}
    return {"loss_kind": tc.loss,
            "logq": logq if tc.loss == "softmax" else None}


def eval_metrics(mc, top_k, params, batch, attrs_table, lookup=None):
    """THE eval computation, shared by every eval-step variant: forward on
    the [B, T+1] candidate block, masked BCE, HR/NDCG sums
    (``src/train.py:35-53``). Returns (hr, ndcg, loss)."""
    kw = {} if lookup is None else {"lookup": lookup}
    y_pred = carca_apply(
        params, mc, (batch["p_x"], None, batch["p_c"]),
        [(batch["o_x"], None, batch["o_c"])],
        train=False, attrs_table=attrs_table, **kw)
    mask = get_mask(batch["o_x"])
    loss = masked_bce(y_pred, batch["y_true"], mask)
    row_mask = get_mask(batch["o_x"][:, 0])  # batch-padding rows
    hr, ndcg = hr_ndcg_sums(y_pred, batch["y_true"], top_k, row_mask)
    return hr, ndcg, loss


@partial(jax.jit, donate_argnums=0)
def ema_update(ema, params, decay):
    """One EMA step: shadow = d·shadow + (1−d)·params, leafwise (Polyak
    averaging, ``TrainConfig.ema_decay``). The old shadow is donated, so
    the running copy costs ONE extra params-sized HBM residency, not two.
    For fused multi-step dispatches fit passes ``decay**inner_steps``: the
    K intermediate parameter states never leave the device, so the shadow
    folds them into one geometric step (documented at the config knob)."""
    return jax.tree_util.tree_map(
        lambda e, p: e * decay + p.astype(e.dtype) * (1.0 - decay),
        ema, params)


def apply_gradients(tx, state, loss_fn, new_rng):
    """value_and_grad + optimizer update + state roll, shared by every
    train-step variant."""
    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params=params, opt_state=opt_state, rng=new_rng,
                      step=state.step + 1), loss


def make_train_step(mc, tx, tc=None) -> Callable:
    """Jitted train step: (state, attrs_table, batch) → (state, loss)."""
    lo = _loss_opts(tc)

    @partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, attrs_table, batch):
        rng, step_rng = jax.random.split(state.rng)
        return apply_gradients(
            tx, state,
            lambda p: train_loss(mc, p, batch, step_rng, attrs_table, **lo),
            rng)

    return train_step


def make_eval_step(mc, top_k: int) -> Callable:
    """Jitted eval step: (params, attrs_table, batch) →
    (hr_sum, ndcg_sum, loss). Mirrors ``evaluate`` (src/train.py:35-53)."""

    @jax.jit
    def eval_step(params, attrs_table, batch):
        return eval_metrics(mc, top_k, params, batch, attrs_table)

    return eval_step


def _sparse_device_update(mc, tc, tx, state, batch, step_rng, rng,
                          attrs_table, base_lookup=None, logq=None):
    """Device-pipeline train update with the lazy row-sparse item-table
    Adam (train/sparse_adam.py): differentiates w.r.t. the gathered
    sub-table so no dense [R, W] gradient materializes, updates dense
    params via the optax chain and the table rows via row-Adam."""
    from carca_tpu.models.embeddings import item_table_width
    from carca_tpu.train import sparse_adam as sa

    table = state.params["embed"]["items"]
    W = item_table_width(mc)
    pack = table.shape[-1] // W
    cap = batch["p_x"].size + batch["o_x"].size
    uphys, posmap = sa.touched_physical_rows(batch, pack, table.shape[0],
                                             cap)
    sub = table[jnp.minimum(uphys, table.shape[0] - 1)]
    # the lookup routes the sub-table by its SubTable marker (identity,
    # not shape — a same-shaped attrs catalog can't misroute)
    lookup = sa.make_sub_lookup(posmap, base_lookup)

    lo = _loss_opts(tc, logq)

    def loss_fn(p):
        return train_loss(mc, p, batch, step_rng, attrs_table, lookup=lookup,
                          **lo)

    loss, grads = jax.value_and_grad(loss_fn)(
        sa.with_items(state.params, sa.SubTable(sub)))
    dense_p = sa.without_items(state.params)
    updates, dense_opt = tx.update(sa.without_items(grads),
                                   state.opt_state["dense"], dense_p)
    dense_new = optax.apply_updates(dense_p, updates)
    new_table, sstate = sa.apply_rows_update(
        table, state.opt_state["items"], uphys,
        grads["embed"]["items"].rows, sub,
        lr=sa.lr_at(tc, state.opt_state["items"]["count"]),
        b1=tc.beta1, b2=tc.beta2, weight_decay=tc.l2_reg)
    return TrainState(params=sa.with_items(dense_new, new_table),
                      opt_state={"dense": dense_opt, "items": sstate},
                      rng=rng, step=state.step + 1), loss


def make_device_train_step(mc, tx, reject_width: int = 0,
                           neg_pop: bool = False, sparse_items: bool = False,
                           tc=None, logq=None) -> Callable:
    """Train step with ON-DEVICE batch assembly: (state, attrs_table,
    catalog_arrays, user_rows [B]) → (state, loss). The only per-step
    host→device transfer is the user-row vector (~1 KB) — essential when
    host→device bandwidth is scarce (see data/device_pipeline.py)."""
    from carca_tpu.data.device_pipeline import assemble_train
    L = mc.seq_len
    n_neg = tc.n_train_negatives if tc is not None else 1
    lo = _loss_opts(tc, logq)

    @partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, attrs_table, arrays, user_rows):
        rng, step_rng, neg_rng = jax.random.split(state.rng, 3)
        batch = assemble_train(arrays, L, mc.n_items, user_rows, neg_rng,
                               reject_width, neg_pop, n_neg=n_neg)
        if sparse_items:
            return _sparse_device_update(mc, tc, tx, state, batch, step_rng,
                                         rng, attrs_table, logq=logq)
        return apply_gradients(
            tx, state,
            lambda p: train_loss(mc, p, batch, step_rng, attrs_table, **lo),
            rng)

    return train_step


def make_scanned_device_train_step(mc, tx, inner_steps: int,
                                   reject_width: int = 0,
                                   neg_pop: bool = False,
                                   sparse_items: bool = False,
                                   tc=None, logq=None) -> Callable:
    """``inner_steps`` on-device train steps per dispatch via ``lax.scan``:
    (state, attrs_table, catalog_arrays, user_rows [K, B]) → (state,
    losses [K]).

    Each dispatch costs a fixed host overhead next to a few-millisecond
    device step; scanning K steps inside one jitted call amortizes that to
    ~1/K per step. The scan body is byte-identical
    to ``make_device_train_step`` (same RNG threading, same assembly), so
    K scanned steps produce exactly the same state as K single steps.
    """
    from carca_tpu.data.device_pipeline import assemble_train
    L = mc.seq_len
    n_neg = tc.n_train_negatives if tc is not None else 1
    lo = _loss_opts(tc, logq)

    @partial(jax.jit, donate_argnums=(0,))
    def scanned_step(state: TrainState, attrs_table, arrays, user_rows):
        def one_step(state: TrainState, rows):
            rng, step_rng, neg_rng = jax.random.split(state.rng, 3)
            batch = assemble_train(arrays, L, mc.n_items, rows, neg_rng,
                                   reject_width, neg_pop, n_neg=n_neg)
            if sparse_items:
                return _sparse_device_update(mc, tc, tx, state, batch,
                                             step_rng, rng, attrs_table,
                                             logq=logq)
            return apply_gradients(
                tx, state,
                lambda p: train_loss(mc, p, batch, step_rng, attrs_table,
                                     **lo),
                rng)

        return jax.lax.scan(one_step, state, user_rows, length=inner_steps)

    return scanned_step


def make_device_eval_step(mc, top_k: int, mode: str,
                          reject_width: int = 0) -> Callable:
    """(params, attrs_table, catalog_arrays, user_rows, rng) →
    (hr_sum, ndcg_sum, loss, n_valid), assembled and scored on device."""
    from carca_tpu.data.device_pipeline import assemble_eval

    @partial(jax.jit, static_argnames=())
    def eval_step(params, attrs_table, arrays, user_rows, rng):
        batch = assemble_eval(arrays, mc.seq_len, mc.target_len, mc.n_items,
                              mode, user_rows, rng, reject_width)
        hr, ndcg, loss = eval_metrics(mc, top_k, params, batch, attrs_table)
        return hr, ndcg, loss, batch["n_valid"]

    return eval_step


def make_scanned_device_eval_step(mc, top_k: int, mode: str,
                                  inner_steps: int,
                                  reject_width: int = 0) -> Callable:
    """``inner_steps`` eval batches per dispatch: (params, attrs_table,
    catalog_arrays, user_rows [K, B], keys [K]) → per-batch (hr, ndcg,
    loss, n_valid) arrays of length K."""
    from carca_tpu.data.device_pipeline import assemble_eval

    @jax.jit
    def scanned_eval(params, attrs_table, arrays, user_rows, keys):
        def body(_, xs):
            rows, key = xs
            batch = assemble_eval(arrays, mc.seq_len, mc.target_len,
                                  mc.n_items, mode, rows, key, reject_width)
            hr, ndcg, loss = eval_metrics(mc, top_k, params, batch,
                                          attrs_table)
            return None, (hr, ndcg, loss, batch["n_valid"])

        _, out = jax.lax.scan(body, None, (user_rows, keys),
                              length=inner_steps)
        return out

    return scanned_eval


def evaluate_device(eval_step, params, attrs_table, arrays, users,
                    batch_size: int, key: jax.Array,
                    scanned_step: Optional[Callable] = None,
                    inner_steps: int = 1) -> Tuple[float, float, float]:
    """Device-pipeline evaluator: same protocol as ``evaluate``. With
    ``scanned_step``, whole [inner_steps, B] blocks go through one dispatch
    (the per-batch RNG folding is identical either way)."""
    batches = list(epoch_batches(users, batch_size, shuffle=False))
    keys = [jax.random.fold_in(key, i) for i in range(len(batches))]
    results = []
    i = 0
    if scanned_step is not None and inner_steps > 1:
        while i + inner_steps <= len(batches):
            block = jnp.asarray(np.stack(batches[i:i + inner_steps]), jnp.int32)
            kblock = jnp.stack(keys[i:i + inner_steps])
            results.append(scanned_step(params, attrs_table, arrays, block,
                                        kblock))
            i += inner_steps
    for j in range(i, len(batches)):
        results.append(eval_step(
            params, attrs_table, arrays, jnp.asarray(batches[j], jnp.int32),
            keys[j]))
    hr = ndcg = loss_sum = 0.0
    total = 0
    n_batches = 0
    for h, n, l, nv in results:
        hr += float(np.sum(np.asarray(h)))
        ndcg += float(np.sum(np.asarray(n)))
        loss_sum += float(np.sum(np.asarray(l)))
        total += int(np.sum(np.asarray(nv)))
        n_batches += np.asarray(l).size
    if total == 0:
        return 0.0, 0.0, 0.0
    return hr / total, ndcg / total, loss_sum / max(n_batches, 1)


def make_retrieval_evaluator(
    cfg: Config,
    catalog: Catalog,
    mode: str = "test",
    k: Optional[int] = None,
    log: bool = True,
    seen_only: bool = True,
    quantized: bool = False,
) -> Callable[[Any], Dict[str, float]]:
    """Build a reusable full-catalog retrieval evaluator: returns
    ``run(params) -> {retrieval_{mode}_hr, retrieval_{mode}_ndcg}``.

    All params-independent work (seen-index row ids, the user batching,
    the jitted embed/score closures) happens once at build time, so the
    per-epoch monitoring path (``TrainConfig.eval_retrieval_every``) pays
    no recompilation after the first epoch. ``evaluate_retrieval`` is the
    one-shot wrapper. Semantics are documented there.
    """
    from carca_tpu.data.device_pipeline import DeviceDataset, _profile_slots
    from carca_tpu.ops.retrieval_topk import quantize_index
    from carca_tpu.parallel.retrieval import (catalog_in_decoder_space,
                                              embed_catalog, queries,
                                              retrieval_hr_ndcg,
                                              topk_given_queries)

    mc, tc = cfg.model, cfg.train
    k = k or tc.top_k
    if mc.decoder == "ca":
        raise ValueError(
            "full-catalog retrieval applies to the dot/wdot decoders; the "
            "cross-attention decoder is a ranking model (see retrieval.py)")
    dd = DeviceDataset(catalog, mc.seq_len, mc.target_len, test=tc.test)
    attrs_table = jnp.asarray(catalog.attrs)
    # bf16 catalog embeddings at multi-million-item scale: halves the [N, d]
    # residency (2.56 GB f32 at 10M, d=64) next to the live train params.
    # The quantized measurement embeds in f32 regardless — serving builds
    # its int8 index from f32 embeddings, and quantizing already-bf16-
    # rounded values would measure a different index than the one served
    emb_dtype = (jnp.bfloat16 if mc.n_items >= 4_000_000 and not quantized
                 else jnp.float32)

    row_ids = None
    index_note = f"{mc.n_items} ids"
    if seen_only:
        # count TRAINING events only: each user's held-out val/test tail
        # is excluded, so an item occurring solely as a held-out positive
        # is NOT indexed (it was never trained on, and counting it would
        # leak held-out information into the index). Uses the ACTUAL train
        # window bounds — windowing floors the window end at 1
        # (src/data.py:53-74), so a short-history user's first event does
        # train and must count — restricted to users the train split
        # actually iterates
        items_np = np.asarray(dd.arrays["items"])
        offsets = np.asarray(catalog.offsets)
        lengths = np.diff(offsets)
        starts = np.asarray(dd.arrays["start_train"])
        ends = np.asarray(dd.arrays["end_train"])
        user_of = np.repeat(np.arange(len(lengths)), lengths)
        pos_in_user = np.arange(len(items_np)) - np.repeat(offsets[:-1],
                                                           lengths)
        trains = np.zeros(len(lengths), bool)
        trains[dd.users("train")] = True
        sel = (trains[user_of] & (pos_in_user >= starts[user_of])
               & (pos_in_user < ends[user_of]))
        counts = np.bincount(items_np[sel], minlength=mc.n_items)
        seen = np.flatnonzero(counts[1:]) + 1  # never index the pad id
        row_ids = jnp.asarray(np.concatenate([[0], seen]), jnp.int32)
        index_note = f"{len(seen)}/{mc.n_items - 1} seen items"
        attrs_in = attrs_table[row_ids]
        embed_fn = jax.jit(lambda p, a: embed_catalog(
            p, mc, a, global_ids=row_ids, out_dtype=emb_dtype))
    else:
        attrs_in = attrs_table
        embed_fn = jax.jit(lambda p, a: embed_catalog(
            p, mc, a, out_dtype=emb_dtype))
    # decoder-space transform applied ONCE per index build (it is per-row;
    # the previous code re-applied it to the whole index inside every jitted
    # eval batch — pure repeated HBM traffic for wdot+l2_norm indexes)
    space_fn = jax.jit(lambda e: catalog_in_decoder_space(e, mc))
    quant_fn = jax.jit(quantize_index) if quantized else None
    if quantized:
        index_note += ", int8"

    @jax.jit
    def batch_metrics(params, attrs_table, emb, user_rows):
        arrays = dd.arrays
        p_evt, valid, alive, e, off = _profile_slots(
            arrays, mode, user_rows, mc.seq_len)
        p_x = jnp.where(valid, arrays["items"][p_evt], 0)
        p_c = arrays["ctx"][p_evt] * valid[..., None]
        pos = jnp.where(alive, arrays["items"][jnp.where(alive, off + e - 1, 0)], 0)
        q = queries(params, mc, (p_x, None, p_c), attrs_table)
        _, ids = topk_given_queries(
            q, emb, mc, k, exclude=p_x, row_ids=row_ids,
            in_decoder_space=True)  # pre-baked once above
        ids = jnp.where(alive[:, None], ids, -1)  # dead rows never match
        hr, ndcg = retrieval_hr_ndcg(ids, pos, k)
        return hr, ndcg, jnp.sum(alive.astype(jnp.int32))

    users = dd.users(mode)
    host_root = np.random.default_rng(tc.seed)
    if len(users) > cfg.data.eval_subsample:
        users = host_root.choice(users, cfg.data.eval_subsample, replace=False)
    row_batches = [jnp.asarray(rows, jnp.int32)
                   for rows in epoch_batches(users, tc.batch_size,
                                             shuffle=False)]

    def run(params) -> Dict[str, float]:
        emb = space_fn(embed_fn(params, attrs_in))
        if quant_fn is not None:
            emb = quant_fn(emb)
        results = [batch_metrics(params, attrs_table, emb, rows)
                   for rows in row_batches]
        hr = sum(float(h) for h, _, _ in results)
        ndcg = sum(float(n) for _, n, _ in results)
        total = sum(int(t) for _, _, t in results)
        out = {f"retrieval_{mode}_hr": hr / max(total, 1),
               f"retrieval_{mode}_ndcg": ndcg / max(total, 1)}
        if tc.verbose and log:
            print(f"Retrieval@{k} ({mode}, index: {index_note}): "
                  f"HR = {out[f'retrieval_{mode}_hr']:.4f}, "
                  f"NDCG = {out[f'retrieval_{mode}_ndcg']:.4f}")
        return out

    return run


def evaluate_retrieval(
    cfg: Config,
    catalog: Catalog,
    params,
    mode: str = "test",
    k: Optional[int] = None,
    log: bool = True,
    seen_only: bool = True,
    quantized: bool = False,
) -> Dict[str, float]:
    """Leave-one-out evaluation against the FULL catalog (BASELINE
    configs[4] protocol; no reference counterpart — its eval samples 100
    negatives, src/data.py:140-192).

    For dot-family decoders: the catalog is embedded once, each user's held
    -out item is ranked among all items (user's visible window excluded),
    and HR@k/NDCG@k of its rank are averaged.

    ``seen_only`` (default) indexes only items with ≥1 training event —
    the production serving posture: items the model never saw carry random
    embeddings whose extreme tail swamps real scores at extreme sparsity
    (measured: 10M-item synthetic, 83% unseen — docs/DESIGN.md #11); a
    real stack handles cold-start items by content, not by ranking noise.
    Held-out positives are events, so the protocol stays well-defined.
    ``seen_only=False`` ranks the entire id space.

    ``quantized`` scores against the int8 serving index
    (``ops/retrieval_topk.quantize_index``) instead of the float
    embeddings — use it to measure the int8 recall delta on a trained
    model at full scale (the serving posture with ``quantize="auto"``).
    """
    return make_retrieval_evaluator(
        cfg, catalog, mode=mode, k=k, log=log, seen_only=seen_only,
        quantized=quantized)(params)


def make_knn_eval_step(top_k: int) -> Callable:
    """Eval step for the non-learned KNN content baseline (``src/knn.py``),
    pluggable into ``evaluate``. HR/NDCG follow the shared harness; the BCE
    loss is computed on scores clipped into (0, 1) — the reference feeds raw
    dot products to BCE (``src/train.py:45``), which NaNs on negative dots;
    ranking metrics are unaffected either way."""

    @jax.jit
    def eval_step(params, attrs_table, batch):
        from carca_tpu.models.knn import knn_apply
        y_pred = knn_apply((batch["p_x"], None, None),
                           [(batch["o_x"], None, None)],
                           attrs_table=attrs_table)
        mask = get_mask(batch["o_x"])
        y_prob = jnp.clip(y_pred, 1e-7, 1.0 - 1e-7)
        loss = masked_bce(y_prob, batch["y_true"], mask)
        row_mask = get_mask(batch["o_x"][:, 0])
        hr, ndcg = hr_ndcg_sums(y_pred, batch["y_true"], top_k, row_mask)
        return hr, ndcg, loss

    return eval_step


def evaluate(
    eval_step: Callable,
    params,
    attrs_table,
    builder: BatchBuilder,
    users: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    mode: str,
) -> Tuple[float, float, float]:
    """(HR/total, NDCG/total, mean batch loss) — src/train.py:35-53."""
    hr = ndcg = loss_sum = 0.0
    total = 0
    n_batches = 0
    def produce():
        for rows in epoch_batches(users, batch_size, shuffle=False):
            b = builder.eval_batch(rows, rng, mode)
            yield int(b.pop("n_valid")), b

    results = []  # device scalars; read only at the end (no per-step sync)
    for n_valid, batch in prefetch(produce()):
        results.append(eval_step(params, attrs_table, batch))
        total += n_valid
        n_batches += 1
    for h, n, l in results:
        hr += float(h)
        ndcg += float(n)
        loss_sum += float(l)
    if total == 0:
        return 0.0, 0.0, 0.0
    return hr / total, ndcg / total, loss_sum / max(n_batches, 1)


def evaluate_knn(cfg: Config, catalog: Catalog, log: bool = True) -> Dict[str, float]:
    """Eval-only KNN baseline through the shared harness (the reference
    pairs ``KNN()`` with the same ``evaluate``, ``src/knn.py`` + SURVEY §3.5)."""
    mc, tc = cfg.model, cfg.train
    builder = BatchBuilder(catalog, mc.seq_len, mc.target_len, test=tc.test)
    attrs_table = jnp.asarray(catalog.attrs)
    step = make_knn_eval_step(tc.top_k)
    rng = np.random.default_rng(tc.seed)
    host_root = np.random.default_rng(tc.seed)
    out: Dict[str, float] = {}
    for mode in ("val", "test"):
        users = builder.users(mode)
        if len(users) > cfg.data.eval_subsample:
            users = host_root.choice(users, cfg.data.eval_subsample,
                                     replace=False)
        hr, ndcg, loss = evaluate(step, {}, attrs_table, builder, users,
                                  tc.batch_size, rng, mode)
        out.update({f"{mode}_hr": hr, f"{mode}_ndcg": ndcg, f"{mode}_loss": loss})
        if tc.verbose and log:
            print(f"KNN {mode}: HR = {hr:.4f}, NDCG = {ndcg:.4f}")
    return out


def fit(
    cfg: Config,
    catalog: Catalog,
    state: Optional[TrainState] = None,
    builder: Optional[BatchBuilder] = None,
    keeper=None,
    log: bool = True,
) -> Tuple[TrainState, Dict[str, float]]:
    """End-to-end training per the reference protocol. Returns the final
    (best) state and a dict of final metrics."""
    mc, tc = cfg.model, cfg.train

    if tc.debug_nans:
        jax.config.update("jax_debug_nans", True)
    # on a multi-host pod every process runs fit(); only process 0 owns the
    # host-side observability surface (stdout, CSV, metrics.jsonl,
    # args.json) — checkpointing stays collective (all processes
    # participate in keeper.save). Without this gate a pod run would write
    # the same CSV from every host (duplicate/racing lines).
    log = log and jax.process_index() == 0
    os.makedirs(tc.out_dir, exist_ok=True)  # idempotent; keeper needs it
    if jax.process_index() == 0:
        # args.json is a config artifact (serving rebuilds the Config from
        # it), not logging — written even under log=False, but only by
        # process 0 on a pod
        cfg.dump_args_json(os.path.join(tc.out_dir, "args.json"))

    dd = None
    if cfg.data.device_pipeline:
        from carca_tpu.data.device_pipeline import DeviceDataset
        dd = DeviceDataset(catalog, mc.seq_len, mc.target_len, test=tc.test)
        builder = dd  # users() source
    elif builder is None:
        native = None
        if cfg.data.use_native:
            from carca_tpu.native import get_assembler
            native = get_assembler()  # None → numpy fallback
        builder = BatchBuilder(
            catalog, mc.seq_len, mc.target_len, test=tc.test, native=native)
    train_users = builder.users("train")
    host_root = np.random.default_rng(tc.seed)
    # val/test subsample fixed once per run (scripts/training.py:154-157)
    val_users = builder.users("val")
    test_users = builder.users("test")
    if len(val_users) > cfg.data.eval_subsample:
        val_users = host_root.choice(val_users, cfg.data.eval_subsample, replace=False)
    if len(test_users) > cfg.data.eval_subsample:
        test_users = host_root.choice(test_users, cfg.data.eval_subsample, replace=False)

    tx = make_optimizer(tc)
    # lazy row-sparse Adam for the item table: ONE resolver, shared with
    # the checkpoint-template builders (it changes the opt-state tree on
    # disk) — see sparse_adam.resolve for the decision and its validation
    from carca_tpu.train import sparse_adam
    sparse_items = sparse_adam.resolve(cfg)

    if state is None:
        state = create_train_state(jax.random.PRNGKey(tc.seed), mc, tc, tx,
                                   sparse_items=sparse_items)

    # multi-chip: TrainConfig.mesh_shape builds the global mesh; the batch
    # rides the 'data' axis (gradient psum by XLA SPMD), embedding tables
    # are row-sharded over 'model' when shard_embeddings (SURVEY.md §2.3).
    # Mesh prep runs BEFORE checkpoint restore so the restore template
    # already carries the padded/sharded table shapes (and the restored
    # optimizer moments are kept — prepare_state_for_mesh re-inits them).
    mesh = None
    if tc.mesh_shape and int(np.prod(tc.mesh_shape)) > 1:
        from carca_tpu.parallel.mesh import (make_mesh, pad_table_rows,
                                             prepare_state_for_mesh)
        mesh = make_mesh(tc.mesh_shape, tc.mesh_axes)
        n_data = mesh.shape.get("data", 1)
        if tc.batch_size % n_data:
            raise ValueError(
                f"batch_size {tc.batch_size} not divisible by the data-axis "
                f"size {n_data}")
        shard_emb = tc.shard_embeddings and mesh.shape.get("model", 1) > 1
        state = prepare_state_for_mesh(state, mesh, tx,
                                       sparse_items=sparse_items)
        attrs_np = (pad_table_rows(catalog.attrs, mesh) if shard_emb
                    else catalog.attrs)
        attrs_table = jnp.asarray(attrs_np, attrs_dtype(mc))
        if jax.process_count() > 1:
            # multi-host: globalize state/attrs up front — jit rejects
            # process-local arrays for non-trivial in_shardings (the
            # sharded-table P('model') leaves; see put_if_multiprocess)
            from carca_tpu.parallel.mesh import (param_shardings,
                                                 table_sharding)
            state = jax.device_put(
                state, param_shardings(state, mesh, shard_emb))
            attrs_table = jax.device_put(
                attrs_table, table_sharding(mesh, shard_emb))
    else:
        attrs_table = jnp.asarray(catalog.attrs, attrs_dtype(mc))

    # checkpoints are always written (the reference always saves its best
    # model, src/train.py:117-124); tc.checkpoint_resume gates only whether
    # a pre-existing latest/ state is restored
    start_epoch = 1
    if keeper is None and tc.checkpoint:
        from carca_tpu.train.checkpoint import CheckpointKeeper
        ckpt_dir = os.path.join(tc.out_dir, "ckpt")
        if not tc.checkpoint_resume and os.path.isdir(ckpt_dir):
            # fresh run: drop stale checkpoints, else the best-NDCG retention
            # would compare against (and at test time reload) a prior run's
            # weights (the reference likewise deletes old .pth files,
            # src/train.py:117-124)
            import shutil
            shutil.rmtree(ckpt_dir)
        keeper = CheckpointKeeper(ckpt_dir, select_by=tc.select_by)
    if tc.checkpoint_resume and keeper is not None:
        try:
            restored = keeper.restore_latest(state)
        except ValueError:
            # the saved opt-state structure disagrees with the freshly
            # resolved sparse_items decision (auto depends on batch size /
            # mesh / embedding — any of which the user may have changed
            # between runs). Retry with the alternate structure and adopt
            # it, so resumes survive config tweaks.
            alt = create_train_state(jax.random.PRNGKey(tc.seed), mc, tc, tx,
                                     sparse_items=not sparse_items)
            if mesh is not None:
                from carca_tpu.parallel.mesh import prepare_state_for_mesh
                alt = prepare_state_for_mesh(alt, mesh, tx,
                                             sparse_items=not sparse_items)
            restored = keeper.restore_latest(alt)
            sparse_items = not sparse_items
            state = alt
            if tc.verbose and log:
                print(f"note: resumed checkpoint uses "
                      f"{'sparse' if sparse_items else 'dense'} item-table "
                      f"Adam; adopting it over the configured setting")
        if restored is not None:
            start_epoch = restored[0] + 1
            state = restored[1]
            if mesh is not None:
                # re-establish the mesh shardings (the donated pjit args
                # require them) whatever the template carried
                from carca_tpu.parallel.mesh import param_shardings
                state = jax.device_put(
                    state, param_shardings(state, mesh, shard_emb))
    # EMA shadow (TrainConfig.ema_decay): seeded from the live weights
    # AFTER restore; a resumed run restores the shadow saved next to
    # latest/ (exact resume) and falls back to re-seeding when none
    # exists. jnp.copy, not an alias: ema_update donates the shadow, and
    # donating buffers that still back state.params would invalidate the
    # live weights on the first step.
    ema_params = None
    if tc.ema_decay:
        if not 0.0 < tc.ema_decay <= 1.0:
            raise ValueError(f"TrainConfig.ema_decay must be in (0, 1], "
                             f"got {tc.ema_decay}")
        if keeper is not None and start_epoch > 1:
            ema_params = keeper.restore_latest_ema(state.params)
            if ema_params is not None and mesh is not None:
                from carca_tpu.parallel.mesh import param_shardings
                ema_params = jax.device_put(
                    ema_params, param_shardings(ema_params, mesh, shard_emb))
        if ema_params is None:
            ema_params = jax.tree_util.tree_map(jnp.copy, state.params)
    ema_d = jnp.float32(tc.ema_decay)
    ema_dK = jnp.float32(tc.ema_decay ** max(tc.inner_steps, 1))

    def ema_after(decay):
        """Roll the shadow after one train-step dispatch (no-op when off)."""
        nonlocal ema_params
        if ema_params is not None:
            ema_params = ema_update(ema_params, state.params, decay)

    # device-pipeline negative-rejection policy (DataConfig.exact_rejection):
    # reject against the user's full history (the reference's exact
    # protocol) unless histories are so long the all-pairs compare would
    # dominate the step
    rw = 0
    neg_pop = cfg.data.neg_distribution == "popularity"
    if neg_pop and dd is None:
        raise ValueError(
            "neg_distribution='popularity' draws from the HBM-resident "
            "event array — it requires device_pipeline=true")
    if tc.loss not in ("bce", "softmax"):
        raise ValueError(f"TrainConfig.loss must be 'bce' or 'softmax', "
                         f"got {tc.loss!r}")
    if tc.n_train_negatives < 1:
        raise ValueError("n_train_negatives must be >= 1")
    if tc.n_train_negatives > 1 and dd is None:
        raise ValueError(
            "n_train_negatives > 1 draws negatives on device — it "
            "requires device_pipeline=true")
    # logQ correction table for sampled softmax under popularity-drawn
    # negatives (losses.sampled_softmax): log empirical unigram probability
    # per item. Uniform sampling needs no correction (constant shift).
    logq = None
    if tc.loss == "softmax" and neg_pop:
        ev = dd.arrays["items"]
        counts = jnp.bincount(ev, length=mc.n_items).astype(jnp.float32)
        logq = jnp.log(jnp.maximum(counts, 1.0)) - jnp.log(float(ev.shape[0]))
    if dd is not None:
        er = cfg.data.exact_rejection
        if er is True or (er == "auto" and dd.hist_max <= 4 * mc.seq_len):
            rw = dd.hist_max
        elif tc.verbose and log:
            # make the protocol deviation auditable at runtime: with the
            # window-only approximation a user's own (unseen) future item
            # can rarely be drawn as a negative — the reference rejects
            # against the FULL history (src/data.py:77-87)
            print(f"note: negative rejection uses the visible window only "
                  f"(hist_max={dd.hist_max} > 4x seq_len={mc.seq_len}, "
                  f"exact_rejection={er!r}); set exact_rejection=true for "
                  f"the reference's full-history protocol")

    if mesh is not None and dd is not None:
        # device-resident pipeline over the mesh: catalog replicated,
        # user rows sharded P('data'), assembly + sampling inside the
        # sharded step — the multi-chip production path
        from carca_tpu.parallel.step import (
            make_sharded_device_eval_step, make_sharded_device_train_step)
        train_step = make_sharded_device_train_step(
            mc, tx, mesh, shard_embeddings=shard_emb, reject_width=rw,
            neg_pop=neg_pop, sparse_items=sparse_items, tc=tc, logq=logq)
        scanned_step = (make_sharded_device_train_step(
                            mc, tx, mesh, shard_embeddings=shard_emb,
                            inner_steps=tc.inner_steps, reject_width=rw,
                            neg_pop=neg_pop, sparse_items=sparse_items,
                            tc=tc, logq=logq)
                        if tc.inner_steps > 1 else None)
        eval_steps = {m: make_sharded_device_eval_step(
                          mc, tc.top_k, mesh, m, shard_embeddings=shard_emb,
                          reject_width=rw)
                      for m in ("val", "test")}
        scanned_evals = {m: (make_sharded_device_eval_step(
                                 mc, tc.top_k, mesh, m,
                                 shard_embeddings=shard_emb,
                                 inner_steps=tc.inner_steps, reject_width=rw)
                             if tc.inner_steps > 1 else None)
                         for m in ("val", "test")}
    elif mesh is not None:
        from carca_tpu.parallel.step import (make_sharded_eval_step,
                                             make_sharded_train_step)
        train_step = make_sharded_train_step(
            mc, tx, mesh, shard_embeddings=shard_emb,
            device_negatives=cfg.data.device_sampling, tc=tc, logq=logq)
        eval_step = make_sharded_eval_step(mc, tc.top_k, mesh,
                                           shard_embeddings=shard_emb)
    elif dd is not None:
        train_step = make_device_train_step(mc, tx, reject_width=rw,
                                            neg_pop=neg_pop,
                                            sparse_items=sparse_items, tc=tc,
                                            logq=logq)
        scanned_step = (make_scanned_device_train_step(
                            mc, tx, tc.inner_steps, reject_width=rw,
                            neg_pop=neg_pop, sparse_items=sparse_items,
                            tc=tc, logq=logq)
                        if tc.inner_steps > 1 else None)
        eval_steps = {m: make_device_eval_step(mc, tc.top_k, m,
                                               reject_width=rw)
                      for m in ("val", "test")}
        scanned_evals = {m: (make_scanned_device_eval_step(
                                 mc, tc.top_k, m, tc.inner_steps,
                                 reject_width=rw)
                             if tc.inner_steps > 1 else None)
                         for m in ("val", "test")}
    else:
        train_step = make_train_step(mc, tx, tc=tc)
        eval_step = make_eval_step(mc, tc.top_k)

    start = datetime.now()
    logpath = os.path.join(
        tc.out_dir,
        f"{start.year}-{start.month}-{start.day}T{start.hour}-{start.minute}-{start.second}.csv",
    )
    logfile = open(logpath, "a") if log else None
    metrics_file = open(os.path.join(tc.out_dir, "metrics.jsonl"), "a") if log else None

    def emit(line: str) -> None:
        if tc.verbose and log:
            print(line)

    # per-epoch full-catalog retrieval monitoring (the sampled val eval is
    # blind to the retrieval regime at extreme sparsity — docs/DESIGN.md
    # §11); evaluator built ONCE so epochs after the first pay no compile
    retrieval_eval = None
    if tc.select_by not in ("ndcg", "retrieval_hr", "retrieval_ndcg"):
        raise ValueError(f"TrainConfig.select_by must be ndcg|retrieval_hr|"
                         f"retrieval_ndcg, got {tc.select_by!r}")
    if tc.eval_retrieval_every:
        if mc.decoder == "ca":
            if tc.select_by != "ndcg":
                raise ValueError("select_by=retrieval_* needs a dot-family "
                                 "decoder (the ca decoder has no retrieval "
                                 "index)")
            emit("note: eval_retrieval_every applies to the dot/wdot "
                 "decoders; skipping retrieval monitoring")
        elif jax.process_count() > 1:
            raise ValueError(
                "eval_retrieval_every is single-host (the retrieval "
                "evaluator jits without mesh shardings); monitor retrieval "
                "offline from the saved checkpoints on a pod")
        else:
            retrieval_eval = make_retrieval_evaluator(cfg, catalog,
                                                      mode="val", log=False)
    if tc.select_by != "ndcg" and retrieval_eval is None:
        raise ValueError(
            f"select_by={tc.select_by!r} selects on the monitored "
            "full-catalog metric — set eval_retrieval_every >= 1")

    def selection_value(m: Dict[str, float]) -> float:
        """The retained-checkpoint comparison metric from a keeper/epoch
        metrics dict (resume must compare apples to apples: a best/
        checkpoint retained under a DIFFERENT select_by restarts the
        comparison from 0 rather than inheriting its score)."""
        if tc.select_by == "ndcg":
            return m["ndcg"]
        if m.get("select_by") == tc.select_by:
            return m["select"]
        return 0.0

    best = selection_value(keeper.best_metrics()) if (keeper and keeper.best_metrics()) else 0.0
    no_improve = 0
    best_in_memory = -1  # epoch whose improving save still matches `state`
    final: Dict[str, float] = {}
    epoch = start_epoch - 1

    for epoch in range(start_epoch, tc.epochs + 1):
        ep_rng = np.random.default_rng([tc.seed, epoch])
        t0 = time.perf_counter()
        n_batches, n_examples = 0, 0
        losses = []  # device scalars; read after the epoch (no per-step sync)
        vb_n, vb_sum = 0, 0.0  # verbose=2 running mean accumulator

        def note_batches(vals, _e=epoch):
            # verbose=2: the reference's per-batch running-mean train-loss
            # prints (src/train.py:99-101). Fetching each loss forces a
            # device sync per dispatch — a debugging mode, like the
            # reference's (its print also syncs the CUDA stream).
            nonlocal vb_n, vb_sum
            if tc.verbose < 2 or not log:
                return
            for v in np.ravel(np.asarray(vals)):
                vb_n += 1
                vb_sum += float(v)
                print(f"Epoch {_e:03d} Batch {vb_n:04d}: "
                      f"Train Loss = {vb_sum / vb_n:.4f}")

        def produce():
            # the sharded step with on-device sampling ignores the negative
            # half; skip the host sampler and halve the shipped o-arrays
            host_negs = not (mesh is not None and cfg.data.device_sampling)
            for rows in epoch_batches(train_users, tc.batch_size, ep_rng,
                                      shuffle=True):
                b = builder.train_batch(rows, ep_rng, negatives=host_negs)
                yield int(b.pop("n_valid")), b

        profiling = tc.profile and epoch == start_epoch + 1  # skip compile epoch
        if profiling:
            jax.profiler.start_trace(os.path.join(tc.out_dir, "profile"))
        if dd is not None:
            pending = []  # [K, B] chunks for the scanned multi-step dispatch
            for rows in epoch_batches(train_users, tc.batch_size, ep_rng,
                                      shuffle=True):
                n_batches += 1
                n_examples += int((rows >= 0).sum())
                if scanned_step is None:
                    state, loss = train_step(state, attrs_table, dd.arrays,
                                             jnp.asarray(rows, jnp.int32))
                    ema_after(ema_d)
                    losses.append(loss)
                    note_batches(loss)
                    continue
                pending.append(rows)
                if len(pending) == tc.inner_steps:
                    state, k_losses = scanned_step(
                        state, attrs_table, dd.arrays,
                        jnp.asarray(np.stack(pending), jnp.int32))
                    ema_after(ema_dK)
                    losses.append(jnp.sum(k_losses))
                    note_batches(k_losses)
                    pending = []
            for rows in pending:  # remainder: single-step dispatches
                state, loss = train_step(state, attrs_table, dd.arrays,
                                         jnp.asarray(rows, jnp.int32))
                ema_after(ema_d)
                losses.append(loss)
                note_batches(loss)
        else:
            for n_valid, batch in prefetch(produce()):
                if profiling:
                    with jax.profiler.StepTraceAnnotation("train",
                                                          step_num=n_batches):
                        state, loss = train_step(state, attrs_table, batch)
                else:
                    state, loss = train_step(state, attrs_table, batch)
                ema_after(ema_d)
                losses.append(loss)
                note_batches(loss)
                n_batches += 1
                n_examples += n_valid
        # fetching the loss sum syncs the device before the epoch clock stops
        sum_loss = float(jnp.sum(jnp.stack(losses))) if losses else 0.0
        if profiling:
            jax.profiler.stop_trace()
        dt = time.perf_counter() - t0

        now = datetime.now().strftime("%H:%M:%S")
        train_loss = sum_loss / max(n_batches, 1)
        emit(f"{now} - Epoch {epoch:03d}: Train Loss = {train_loss:.4f} "
             f"({n_examples / max(dt, 1e-9):.0f} ex/s)")
        if logfile:
            logfile.write(f"{now};{epoch};train;{train_loss};;\n")

        t1 = time.perf_counter()
        # under EMA, EVERYTHING downstream of training evaluates the
        # shadow (sampled val, retrieval monitoring, retention, test):
        # the shadow is what a deployment serves, so selection and
        # early-stop must watch its curve, not the raw weights'
        eparams = state.params if ema_params is None else ema_params
        if dd is not None:
            hr, ndcg, val_loss = evaluate_device(
                eval_steps["val"], eparams, attrs_table, dd.arrays,
                val_users, tc.batch_size,
                jax.random.fold_in(jax.random.PRNGKey(tc.seed), epoch),
                scanned_step=scanned_evals["val"], inner_steps=tc.inner_steps)
        else:
            hr, ndcg, val_loss = evaluate(
                eval_step, eparams, attrs_table, builder, val_users,
                tc.batch_size, ep_rng, "val")
        dt_eval = time.perf_counter() - t1

        now = datetime.now().strftime("%H:%M:%S")
        emit(f"{now} - Epoch {epoch:03d}: Val Loss = {val_loss:.4f} "
             f"HR = {hr:.4f}, NDCG = {ndcg:.4f}")
        if logfile:
            logfile.write(f"{now};{epoch};val;{val_loss};{hr};{ndcg}\n")
            logfile.flush()
        if metrics_file:
            metrics_file.write(json.dumps({
                "epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                "val_hr": hr, "val_ndcg": ndcg,
                "examples_per_sec": n_examples / max(dt, 1e-9),
                "candidates_per_sec": len(val_users) * (mc.target_len + 1) / max(dt_eval, 1e-9),
                "epoch_seconds": dt,
            }) + "\n")
            metrics_file.flush()

        final = {"val_hr": hr, "val_ndcg": ndcg, "val_loss": val_loss,
                 "epochs_run": epoch}
        rmetrics = None
        if retrieval_eval is not None and epoch % tc.eval_retrieval_every == 0:
            t2 = time.perf_counter()
            rmetrics = retrieval_eval(eparams)
            now = datetime.now().strftime("%H:%M:%S")
            emit(f"{now} - Epoch {epoch:03d}: Retrieval@{tc.top_k} (val) "
                 f"HR = {rmetrics['retrieval_val_hr']:.4f}, "
                 f"NDCG = {rmetrics['retrieval_val_ndcg']:.4f} "
                 f"({time.perf_counter() - t2:.1f}s)")
            if metrics_file:
                metrics_file.write(json.dumps({"epoch": epoch, **rmetrics})
                                   + "\n")
                metrics_file.flush()
            final.update(rmetrics)

        # retained-checkpoint decision (src/train.py:114-124 semantics;
        # tc.select_by optionally keys it on the monitored retrieval
        # metric instead of sampled NDCG — config.py rationale). With
        # eval_retrieval_every > 1, retrieval-selected runs only decide
        # on monitored epochs.
        if tc.select_by == "ndcg":
            candidate = ndcg
        else:
            candidate = (rmetrics[f"retrieval_val{tc.select_by[9:]}"]
                         if rmetrics is not None else None)
        if candidate is not None:
            if candidate > best:
                best, no_improve = candidate, 0
                best_in_memory = epoch
                if keeper is not None:
                    m = {"ndcg": ndcg, "hr": hr, "epoch": epoch}
                    if tc.select_by != "ndcg":
                        m.update(select=candidate, select_by=tc.select_by,
                                 **rmetrics)
                    if ema_params is not None:
                        m["ema_decay"] = tc.ema_decay
                    # best/ holds the EVALUATED weights — the EMA shadow
                    # when enabled (what test/serving must load)
                    keeper.save(epoch, state.replace(params=eparams), m)
            else:
                no_improve += 1
        # resume point (full state incl. optimizer moments) on its own
        # cadence — best/ is params-only, so it can't serve as one. The
        # first epoch always saves so a fresh run never has a zero-resume
        # window (interval=10 would otherwise leave epochs 1-9 unprotected)
        if keeper is not None and (epoch % max(tc.checkpoint_interval, 1) == 0
                                   or epoch == start_epoch):
            keeper.save_latest(epoch, state, ema=ema_params)
        if no_improve >= tc.early_stop:
            emit(f"No improvement in {no_improve} epochs, early stopping...")
            break

    # reload best and run the held-out test split (src/train.py:141-149).
    # When the final epoch improved, the live state already IS the best
    # state — skip the disk round-trip (the 10M-item state is ~5 GB each
    # way; the saved copy is byte-identical to what's in memory)
    restored = (keeper.restore_best(state)
                if keeper is not None and best_in_memory != epoch else None)
    if restored is not None:
        state = restored[1]
    elif ema_params is not None:
        # the live shadow IS the weights the last improving epoch
        # evaluated/saved — no disk round-trip, mirroring the raw-params
        # fast path above
        state = state.replace(params=ema_params)
    if len(test_users) and tc.test:
        if dd is not None:
            hr, ndcg, test_loss = evaluate_device(
                eval_steps["test"], state.params, attrs_table, dd.arrays,
                test_users, tc.batch_size,
                jax.random.fold_in(jax.random.PRNGKey(tc.seed), 999_983),
                scanned_step=scanned_evals["test"],
                inner_steps=tc.inner_steps)
        else:
            hr, ndcg, test_loss = evaluate(
                eval_step, state.params, attrs_table, builder, test_users,
                tc.batch_size, np.random.default_rng([tc.seed, 999_983]), "test")
        now = datetime.now().strftime("%H:%M:%S")
        emit(f"{now} - Epoch {epoch:03d}: Test Loss = {test_loss:.4f} "
             f"HR = {hr:.4f}, NDCG = {ndcg:.4f}")
        if logfile:
            logfile.write(f"{now};{epoch};test;{test_loss};{hr};{ndcg}\n")
        final.update({"test_hr": hr, "test_ndcg": ndcg, "test_loss": test_loss})

    if logfile:
        logfile.close()
    if metrics_file:
        metrics_file.close()
    if keeper is not None:
        keeper.close()
    return state, final
