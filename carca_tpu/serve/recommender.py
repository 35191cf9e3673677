"""Two-stage top-k recommender for online serving.

The reference stops at offline evaluation (``src/train.py:35-53`` scores
1+100 *sampled* candidates); serving needs the opposite shape of problem —
rank the **whole catalog** for a handful of users at low latency. The
design:

* **Stage 1 — retrieval.** The catalog is embedded once at load time with
  the item tower (``parallel/retrieval.embed_catalog``) and kept in device
  memory. Per request, the profile tower encodes the user history, and
  the tournament top-k kernel (``ops/retrieval_topk``) scans the catalog
  embeddings against the last profile state — the ``[B, n_items]`` score
  matrix never exists. The user's own history is excluded (over-retrieve
  k+L, filter, re-top-k).
* **Stage 2 — reranking.** For cross-attention models (``decoder="ca"``)
  the shortlist is re-scored with the real decoder (targets attend over the
  full encoded profile, eval semantics: no causal mask,
  ``src/carca.py:339-340``). For the dot-family decoders stage 1 *is* the
  decoder's eval math (``src/carca.py:362``), so reranking is skipped and
  only the score mapping (sigmoid / cosine→[0,1]) is applied.
* **Static shapes.** Requests are padded to a fixed ``seq_len`` window
  (right-aligned, like training; ``src/data.py:112-124``) and batch sizes
  are bucketed to a small set of powers of two, so every request shape hits
  a cached XLA executable — no recompiles in steady state.

Request context: candidates are scored under the *request's* context vector
(e.g. current time), broadcast over the shortlist — the serving analogue of
eval candidates sharing the held-out positive's context
(``src/data.py:181-187``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from carca_tpu.config import Config, ModelConfig, TrainConfig
from carca_tpu.models.carca import encode_profile, score_targets
from carca_tpu.parallel.retrieval import (embed_catalog, query_from_encoded,
                                          topk_given_queries)

NEG_INF = jnp.float32(-jnp.inf)


def pad_histories(
    histories: Sequence[Sequence[int]],
    seq_len: int,
    ctxs: Optional[Sequence[np.ndarray]] = None,
    n_ctx: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-align each history into a fixed [B, seq_len] window.

    Keeps the most recent ``seq_len`` events (the training window policy,
    ``src/data.py:112-124``); ``ctxs`` are per-event context rows aligned
    with each history (missing → zeros). Returns (p_x int32, p_c float32).
    """
    b = len(histories)
    p_x = np.zeros((b, seq_len), np.int32)
    p_c = np.zeros((b, seq_len, n_ctx), np.float32)
    for i, hist in enumerate(histories):
        tail = list(hist)[-seq_len:]
        if not tail:
            continue
        p_x[i, seq_len - len(tail):] = tail
        if ctxs is not None and ctxs[i] is not None:
            c = np.asarray(ctxs[i], np.float32)[-seq_len:]
            p_c[i, seq_len - len(tail):] = c
    return p_x, p_c


def _map_scores(raw: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Raw dot scores → the decoder's output range (src/carca.py:358-395)."""
    if cfg.decoder == "wdot" and cfg.l2_norm:
        return (raw + 1.0) / 2.0
    return jax.nn.sigmoid(raw)




class Recommender:
    """Compiled top-k recommendation over a fixed catalog.

    Parameters
    ----------
    params, cfg:
        Trained CARCA parameters and their architecture config.
    attrs_table:
        [n_items, n_attrs] item attribute catalog (row 0 = pad).
    shortlist:
        Stage-1 candidate count fed to the reranker (``decoder="ca"`` only).
    exclude_history:
        Remove the user's own (visible-window) items from results.
    batch_buckets:
        Allowed compiled batch sizes; requests are padded up to the nearest.
    index_ids:
        Optional global item ids to index (e.g. items with ≥1 event — the
        seen-items serving posture, docs/DESIGN.md #11). Stage 1 then
        embeds and streams only those rows (20× less catalog traffic at
        the 10M preset's sparsity); everything else — reranking, explicit
        candidate scoring — still covers the full id space.
    quantize:
        ``True | False | "auto"`` — store the stage-1 index as per-row
        symmetric int8 (``ops/retrieval_topk.quantize_index``): ¼ the HBM
        catalog scan per request, which bounds stage-1 latency at large
        indexes. Stage-1 scores become approximate (quantization step
        ≤ max|row|/127 per coordinate); with the cross-attention reranker
        the shortlist is re-scored exactly, so end-to-end results only
        change when a true candidate falls outside the over-provisioned
        shortlist. "auto" quantizes indexes of ≥ 1M rows, where the scan
        actually dominates.
    mesh:
        Optional ``Mesh`` with a ``model`` axis: the stage-1 index is
        row-sharded across it (each card holds and streams 1/N of the
        rows; only [shards, k+E] candidates cross the interconnect per
        request — ``parallel.retrieval.topk_given_queries_sharded``).
        This is how an index beyond one card's memory serves (e.g. 100M
        rows); params and the attrs catalog stay replicated.
    use_kernel:
        Stage 1 through the tournament kernel (default). ``False`` runs
        the plain XLA reference instead, which writes the whole
        ``[B, index rows]`` score matrix — for checking, not serving.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        attrs_table: np.ndarray,
        *,
        shortlist: int = 512,
        exclude_history: bool = True,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
        default_ctx: Optional[np.ndarray] = None,
        index_ids: Optional[np.ndarray] = None,
        quantize=False,
        mesh=None,
        use_kernel: bool = True,
    ):
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.exclude_history = exclude_history
        self.batch_buckets = tuple(sorted(batch_buckets))
        if mesh is not None:
            # params/attrs stay REPLICATED over the index mesh (class
            # docstring). Checkpoint-restored arrays arrive committed to
            # a single device, and jit rejects mixing committed
            # device-0 inputs with mesh out_shardings ("incompatible
            # devices") — found serving a restored run with
            # --index_shards 2; fresh params hid it (uncommitted arrays
            # place freely).
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(mesh, P())
            params = jax.device_put(
                params, jax.tree_util.tree_map(lambda _: rep, params))
            attrs_table = jax.device_put(
                jnp.asarray(attrs_table, jnp.float32), rep)
        self.params = params
        self.attrs = jnp.asarray(attrs_table, jnp.float32)
        self.default_ctx = (np.zeros((cfg.n_ctx,), np.float32)
                            if default_ctx is None
                            else np.asarray(default_ctx, np.float32))
        # optional compacted stage-1 index (row 0 = pad id 0): serve only
        # items that exist / were interacted with — 20× less catalog
        # streaming at the 10M preset's sparsity (docs/DESIGN.md #11)
        self.row_ids = None
        index_size = cfg.n_items
        if index_ids is not None:
            ids = np.asarray(index_ids, np.int64)
            ids = np.unique(ids[(ids > 0) & (ids < cfg.n_items)])
            self.row_ids = jnp.asarray(np.concatenate([[0], ids]), jnp.int32)
            index_size = len(ids)
        self.shortlist = min(shortlist, index_size)
        # catalog embedded (and moved into decoder score space — e.g. the
        # wdot cosine normalization) ONCE at load time; the item tower is
        # query-independent at serving: candidates take the request ctx in
        # the reranker; stage 1 uses the neutral ctx, standard two-tower
        from carca_tpu.parallel.retrieval import catalog_in_decoder_space
        # strict identity checks: `1 in (True, False, "auto")` is True
        # because 1 == True, but `1 is True` is False and would silently
        # disable quantization downstream
        if not (quantize is True or quantize is False or quantize == "auto"):
            raise ValueError(f"quantize must be True/False/'auto', got {quantize!r}")
        do_quant = quantize is True or (quantize == "auto"
                                        and index_size >= 1_000_000)
        # the k-validation bound: REAL candidates only — excludes the pad
        # row (id 0 scores -inf and can never be a recommendation), and
        # never the sharding pad
        self._index_rows = (index_size if index_ids is not None
                            else cfg.n_items - 1)

        def build(p, a, ri):
            rows = a if ri is None else a[ri]
            gids = ri if ri is not None else None
            e = catalog_in_decoder_space(
                embed_catalog(p, cfg, rows, global_ids=gids), cfg)
            if do_quant:
                from carca_tpu.ops.retrieval_topk import quantize_index
                return quantize_index(e)
            return e

        self.mesh = mesh
        out_shardings = None
        ri_in = self.row_ids
        if mesh is not None:
            # build the index SHARDED: out_shardings row-shards the whole
            # embed computation across the mesh, so the float intermediate
            # never materializes on one chip (a 100M-row f32 index is
            # ~25 GB — the very scale the mesh exists for). Pad the input
            # row set to the shard multiple first; pad rows embed to zero
            # (id 0 / ≥ n_items ⇒ masked) and sit beyond the true row
            # count, which the sharded top-k masks by global row index.
            from jax.sharding import NamedSharding, PartitionSpec as P

            from carca_tpu.ops.retrieval_topk import QuantizedIndex
            n = mesh.shape["model"]
            if ri_in is None and cfg.n_items % n:
                ri_in = jnp.arange(cfg.n_items, dtype=jnp.int32)
            if ri_in is not None:
                pad = (-ri_in.shape[0]) % n
                if pad:
                    ri_in = jnp.concatenate(
                        [ri_in, jnp.zeros((pad,), jnp.int32)])
            rows_sh = NamedSharding(mesh, P("model", None))
            out_shardings = (QuantizedIndex(
                rows_sh, NamedSharding(mesh, P(None, "model")))
                if do_quant else rows_sh)
        if ri_in is None:
            self.catalog_emb = jax.jit(
                lambda p, a: build(p, a, None),
                out_shardings=out_shardings)(params, self.attrs)
        else:
            self.catalog_emb = jax.jit(
                build, out_shardings=out_shardings)(
                    params, self.attrs, ri_in)
        self._rerank = cfg.decoder == "ca"
        # per-instance executable caches (a class-level lru_cache would pin
        # retired Recommenders — params + HBM catalog — alive forever)
        self._fns: Dict[int, callable] = {}
        self._score_fns: Dict[int, callable] = {}

    def _compiled(self, k: int):
        if k in self._fns:
            return self._fns[k]
        cfg, shortlist, rerank = self.cfg, self.shortlist, self._rerank
        exclude = self.exclude_history
        row_ids = self.row_ids
        mesh = self.mesh
        use_kernel = self.use_kernel

        @jax.jit
        def fn(params, attrs, catalog_emb, p_x, p_c, req_ctx):
            p_e, p_mask = encode_profile(
                params, cfg, (p_x, None, p_c), train=False, attrs_table=attrs)
            q = query_from_encoded(p_e, cfg)
            n1 = shortlist if rerank else k
            if mesh is not None:
                from carca_tpu.parallel.retrieval import \
                    topk_given_queries_sharded
                sv, sids = topk_given_queries_sharded(
                    q, catalog_emb, cfg, n1, mesh,
                    exclude=p_x if exclude else None, row_ids=row_ids,
                    use_kernel=use_kernel)
            else:
                sv, sids = topk_given_queries(
                    q, catalog_emb, cfg, n1,
                    exclude=p_x if exclude else None, in_decoder_space=True,
                    row_ids=row_ids, use_kernel=use_kernel)
            if not rerank:
                # keep pad/exhausted slots at -inf (sigmoid would fold them
                # to 0.0, indistinguishable from a real low score)
                return jnp.where(jnp.isfinite(sv), _map_scores(sv, cfg),
                                 NEG_INF), sids
            # stage 2: score the shortlist with the real decoder under the
            # request context (candidate attrs gathered on device)
            o_c = jnp.broadcast_to(req_ctx[:, None, :],
                                   (p_x.shape[0], n1, cfg.n_ctx))
            y = score_targets(params, cfg, p_e, p_mask,
                              [(sids, None, o_c)], train=False,
                              attrs_table=attrs)
            # stage-1 pad/exhausted slots carry -inf; keep them out of top-k
            y = jnp.where(jnp.isfinite(sv), y, NEG_INF)
            v, sel = jax.lax.top_k(y, k)
            return v, jnp.take_along_axis(sids, sel, axis=1)

        self._fns[k] = fn
        return fn

    def _bucket(self, b: int) -> int:
        for size in self.batch_buckets:
            if b <= size:
                return size
        return b  # oversized request: compile once for its exact size

    def recommend(
        self,
        histories: Sequence[Sequence[int]],
        *,
        k: int = 10,
        ctxs: Optional[Sequence[np.ndarray]] = None,
        request_ctx: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (ids [B,k], scores [B,k]) for a batch of user histories.

        ``ctxs``: per-event context rows aligned with each history.
        ``request_ctx``: [n_ctx] or [B, n_ctx] context the candidates are
        scored under (default: the recommender's ``default_ctx``).
        """
        b = len(histories)
        if self._rerank and k > self.shortlist:
            raise ValueError(f"k={k} exceeds shortlist={self.shortlist}")
        if k > self._index_rows:  # true rows, never the sharding pad
            raise ValueError(
                f"k={k} exceeds the stage-1 index ({self._index_rows})")
        bb = self._bucket(b)
        p_x, p_c = pad_histories(histories, self.cfg.seq_len, ctxs,
                                 self.cfg.n_ctx)
        if bb != b:
            p_x = np.pad(p_x, ((0, bb - b), (0, 0)))
            p_c = np.pad(p_c, ((0, bb - b), (0, 0), (0, 0)))
        rc = self.default_ctx if request_ctx is None else np.asarray(
            request_ctx, np.float32)
        rc = np.broadcast_to(rc, (bb, self.cfg.n_ctx)) if rc.ndim == 1 else \
            np.pad(rc, ((0, bb - b), (0, 0)))
        v, ids = self._compiled(int(k))(
            self.params, self.attrs, self.catalog_emb,
            jnp.asarray(p_x), jnp.asarray(p_c), jnp.asarray(rc))
        return np.asarray(ids)[:b], np.asarray(v)[:b]

    def score_candidates(
        self,
        histories: Sequence[Sequence[int]],
        candidates: np.ndarray,
        *,
        ctxs: Optional[Sequence[np.ndarray]] = None,
        request_ctx: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Decoder scores [B, N] for explicit candidate ids [B, N] — the
        direct ranking API (ads/sponsored slots, A/B shadow scoring)."""
        b, n = candidates.shape
        bb = self._bucket(b)
        p_x, p_c = pad_histories(histories, self.cfg.seq_len, ctxs,
                                 self.cfg.n_ctx)
        cand = np.asarray(candidates, np.int32)
        if bb != b:
            p_x = np.pad(p_x, ((0, bb - b), (0, 0)))
            p_c = np.pad(p_c, ((0, bb - b), (0, 0), (0, 0)))
            cand = np.pad(cand, ((0, bb - b), (0, 0)))
        rc = self.default_ctx if request_ctx is None else np.asarray(
            request_ctx, np.float32)
        rc = np.broadcast_to(rc, (bb, self.cfg.n_ctx)) if rc.ndim == 1 else \
            np.pad(rc, ((0, bb - b), (0, 0)))
        y = self._score_compiled(n)(
            self.params, self.attrs,
            jnp.asarray(p_x), jnp.asarray(p_c), jnp.asarray(cand),
            jnp.asarray(rc))
        return np.asarray(y)[:b]

    def _score_compiled(self, n: int):
        if n in self._score_fns:
            return self._score_fns[n]
        cfg = self.cfg

        @jax.jit
        def fn(params, attrs, p_x, p_c, cand, req_ctx):
            p_e, p_mask = encode_profile(
                params, cfg, (p_x, None, p_c), train=False, attrs_table=attrs)
            o_c = jnp.broadcast_to(req_ctx[:, None, :],
                                   (p_x.shape[0], n, cfg.n_ctx))
            return score_targets(params, cfg, p_e, p_mask,
                                 [(cand, None, o_c)], train=False,
                                 attrs_table=attrs)

        self._score_fns[n] = fn
        return fn

    def warmup(self, k: int = 10) -> None:
        """Compile every batch bucket ahead of traffic."""
        for bb in self.batch_buckets:
            self.recommend([[1]] * bb, k=k)


def config_from_run_dir(run_dir: str) -> Config:
    """Rebuild the training Config from a run directory's ``args.json``
    (the flat dump written by ``train/loop.fit``). Keys that are no longer
    config fields (e.g. ``use_pallas`` in older runs) are ignored."""
    with open(os.path.join(run_dir, "args.json")) as fh:
        flat = json.load(fh)
    import dataclasses

    from carca_tpu.config import DataConfig

    def pick(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in flat.items() if k in names}
        # tuples serialize as lists; frozen dataclasses want them back
        for f in dataclasses.fields(cls):
            if f.name in kw and isinstance(kw[f.name], list):
                kw[f.name] = tuple(kw[f.name])
        return cls(**kw)

    return Config(model=pick(ModelConfig), data=pick(DataConfig),
                  train=pick(TrainConfig))


def load_recommender(
    run_dir: str,
    attrs_table: np.ndarray,
    *,
    which: str = "best",
    **kwargs,
) -> Recommender:
    """Restore a trained run (``{run_dir}/ckpt/{best,latest}``) into a
    compiled Recommender. ``attrs_table`` is the item catalog the run was
    trained against (checkpoints store parameters, not data)."""
    from carca_tpu.train.checkpoint import CheckpointKeeper
    from carca_tpu.train.state import create_train_state, make_optimizer

    cfg = config_from_run_dir(run_dir)
    tx = make_optimizer(cfg.train)
    from carca_tpu.train import sparse_adam
    template = create_train_state(jax.random.PRNGKey(0), cfg.model,
                                  cfg.train, tx,
                                  sparse_items=sparse_adam.resolve(cfg))
    keeper = CheckpointKeeper(os.path.join(run_dir, "ckpt"))
    try:
        restore = (keeper.restore_best if which == "best"
                   else keeper.restore_latest)
        got = restore(template)
        if got is None:
            raise FileNotFoundError(
                f"no {which!r} checkpoint under {run_dir}/ckpt")
        _, state = got
    finally:
        keeper.close()
    return Recommender(state.params, cfg.model, attrs_table, **kwargs)
