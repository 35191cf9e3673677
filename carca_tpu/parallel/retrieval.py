"""Full-catalog retrieval scoring with a sharded top-k.

BASELINE.json configs[4]: rank the **entire catalog** (10M items) per query
instead of 1+100 sampled candidates. The reference has no such path (its
eval is sampled-negatives only, ``src/data.py:140-192``); the design:

* the catalog is embedded **once per evaluation** (not per user) with the
  item tower — exact for attr/id/mlpid embeddings; for ctx-fusing
  embeddings (all/attrctx) a query-independent context (zeros by default)
  is used, the standard two-tower retrieval approximation;
* item/attr tables stay row-sharded over the ``model`` axis: each chip
  embeds its rows, scores them against its data-shard of query states
  (the tournament kernel, ``ops/retrieval_topk.py``), takes a **local**
  top-k, and only the ``[shards, k]`` candidates are all-gathered and
  re-reduced — the ``[B, n_items]`` score matrix never exists in device
  memory and never crosses the interconnect;
* retrieval applies to the dot-family decoders (two-tower geometry: score =
  last profile state · item embedding, ``src/carca.py:362``); the
  cross-attention decoder is a *ranking* model — O(L) attention per
  candidate — and is evaluated on shortlists, not the full catalog.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from carca_tpu.config import ModelConfig
from carca_tpu.models import embeddings
from carca_tpu.models.carca import encode_profile

NEG_INF = jnp.float32(-jnp.inf)


def embed_catalog(
    params,
    cfg: ModelConfig,
    attrs_rows: jnp.ndarray,
    ctx: Optional[jnp.ndarray] = None,
    *,
    table_rows: Optional[jnp.ndarray] = None,
    global_ids: Optional[jnp.ndarray] = None,
    row_chunk: int = 1 << 20,
    out_dtype=jnp.float32,
) -> jnp.ndarray:
    """Item-tower embeddings for catalog rows → [R, d].

    ``attrs_rows`` [R, n_attrs] are the rows to embed. ``global_ids`` [R]
    are their true item ids (default ``arange(R)``) — used for pad masking
    (id 0 and padded table rows embed to zero). ``table_rows`` overrides the
    id-embedding table with a row-aligned local shard (then lookups use
    local row numbers). Target semantics: no positional encoding
    (``src/carca.py:91-92``).

    Catalogs larger than ``row_chunk`` are embedded in slices with
    ``lax.map`` — the feature-fusion hidden layer would otherwise
    materialize ``[R, g]`` (10 GB at 10M rows, g=256) in one shot.
    """
    r = attrs_rows.shape[0]
    if global_ids is None:
        global_ids = jnp.arange(r, dtype=jnp.int32)
    if ctx is None:
        ctx = jnp.zeros((cfg.n_ctx,), jnp.float32)

    p_embed = params["embed"]
    x = jnp.arange(r, dtype=jnp.int32) if table_rows is not None else global_ids
    if table_rows is not None and "items" in p_embed:
        p_embed = dict(p_embed, items=table_rows)

    def embed_slice(attrs_s, x_s, gid_s):
        cc = jnp.broadcast_to(ctx[None, :], (attrs_s.shape[0], cfg.n_ctx))
        mask = ((gid_s != 0) & (gid_s < cfg.n_items)).astype(jnp.float32)
        return embeddings.embedding_apply(
            p_embed, cfg, x_s[None], attrs_s[None], cc[None], mask[None],
            target=True)[0].astype(out_dtype)

    if r <= row_chunk:
        return embed_slice(attrs_rows, x, global_ids)

    # index-based chunking: dynamic_slice per chunk instead of a padded
    # reshape copy of the whole catalog (that copy alone is GBs at 10M rows)
    pad = (-r) % row_chunk
    n = (r + pad) // row_chunk
    last = r - row_chunk  # only the final chunk's start is ever clamped

    def body(i):
        s = jnp.minimum(i * row_chunk, last)
        return embed_slice(
            jax.lax.dynamic_slice_in_dim(attrs_rows, s, row_chunk),
            jax.lax.dynamic_slice_in_dim(x, s, row_chunk),
            jax.lax.dynamic_slice_in_dim(global_ids, s, row_chunk))

    e = jax.lax.map(body, jnp.arange(n))  # [n, row_chunk, d]
    if pad == 0:
        return e.reshape(n * row_chunk, -1)
    # the clamped last chunk re-embeds its first `pad` rows; drop them
    return jnp.concatenate(
        [e[:-1].reshape(-1, e.shape[-1]), e[-1, pad:]], axis=0)


def query_from_encoded(p_e: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Encoded profile [B, L, d] → retrieval query [B, d]: the dot decoder's
    eval query (``p[:, -1:, :]``, src/carca.py:362) with the wdot γ-scale
    (and cosine-mode normalization) folded in."""
    q = p_e[:, -1, :]
    if cfg.decoder == "wdot":
        L = p_e.shape[1]
        scale = jnp.cumsum(cfg.gamma ** jnp.arange(L, dtype=jnp.float32))[-1]
        q = q * scale
        if cfg.l2_norm:
            q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q


def queries(params, cfg: ModelConfig, profile, attrs_table) -> jnp.ndarray:
    """Encode the profile and reduce it to the retrieval query (see
    ``query_from_encoded``)."""
    p_e, _ = encode_profile(params, cfg, profile, train=False,
                            attrs_table=attrs_table)
    return query_from_encoded(p_e, cfg)


def catalog_in_decoder_space(e: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Catalog embeddings → the space the decoder scores in.

    The wdot cosine mode normalizes **both** sides (``src/carca.py:381-391``);
    queries are normalized in ``query_from_encoded``, catalog rows here, so
    dot-product retrieval ranks identically to the decoder."""
    if cfg.decoder == "wdot" and cfg.l2_norm:
        return e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
    return e


def _masked_scores(q, e, ids, exclude):
    """[B, R] dot scores; pad id 0 and per-user exclusions at −inf."""
    s = jnp.einsum("bd,rd->br", q, e, preferred_element_type=jnp.float32)
    s = jnp.where((ids == 0)[None, :], NEG_INF, s)
    if exclude is not None:
        hit = jnp.any(ids[None, None, :] == exclude[:, :, None], axis=1)
        s = jnp.where(hit, NEG_INF, s)
    return s


def filter_excluded(v: jnp.ndarray, ids: jnp.ndarray,
                    exclude: jnp.ndarray, k: int):
    """Mask retrieved ids appearing in ``exclude`` [B, E] (0 entries are
    no-ops against real ids), then re-top-k down to ``k`` — the shared
    over-retrieve-then-filter step."""
    hit = jnp.any(ids[:, :, None] == exclude[:, None, :], axis=-1)
    v = jnp.where(hit, NEG_INF, v)
    v, sel = jax.lax.top_k(v, k)
    return v, jnp.take_along_axis(ids, sel, axis=1)


def topk_given_queries(
    q: jnp.ndarray,
    e: jnp.ndarray,
    cfg: ModelConfig,
    k: int,
    *,
    exclude: Optional[jnp.ndarray] = None,
    use_kernel: bool = True,
    in_decoder_space: bool = False,
    row_ids: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-device top-k of precomputed queries [B, d] against precomputed
    catalog embeddings [R, d] (rows aligned with item ids; pad rows beyond
    ``cfg.n_items`` allowed). Returns (scores [B, k], ids [B, k]); ``exclude``
    [B, E] masks per-user ids (0 entries are no-ops). Pass
    ``in_decoder_space=True`` when ``e`` was already run through
    ``catalog_in_decoder_space`` (serving pre-normalizes once at load time —
    re-normalizing a 10M-row catalog per request is pure HBM waste).

    ``row_ids`` [R] makes ``e`` a *compacted* index: row r holds the item
    with global id ``row_ids[r]`` (row 0 must be the pad, id 0). Returned
    ids are global; exclusion happens in global id space. This is how a
    seen-only serving index scores a sub-catalog without reshaping the
    model's tables (``evaluate_retrieval(seen_only=True)``).

    ``e`` may be a ``QuantizedIndex`` (int8 rows + per-row scales —
    ops/retrieval_topk.quantize_index); it must then already be in
    decoder space (the scales bake the row geometry in).

    ``use_kernel=False`` is the plain XLA reference: it writes the whole
    ``[B, R]`` score matrix (and dequantizes an int8 index whole)."""
    from carca_tpu.ops.retrieval_topk import QuantizedIndex, dequantize_index

    quantized = isinstance(e, QuantizedIndex)
    rows = e.rows if quantized else e.shape[0]
    if k > rows:
        raise ValueError(
            f"top-k k={k} exceeds the catalog size {rows}")
    if quantized:
        if not in_decoder_space:
            raise ValueError(
                "a QuantizedIndex is built from decoder-space embeddings; "
                "pass in_decoder_space=True (see quantize_index)")
        if not use_kernel:
            e = dequantize_index(e)  # exact float reconstruction
    elif not in_decoder_space:
        e = catalog_in_decoder_space(e, cfg)
    n_local = rows if row_ids is not None else cfg.n_items
    if use_kernel:
        kk = min(k + (exclude.shape[1] if exclude is not None else 0), rows)
        from carca_tpu.ops.retrieval_topk import catalog_topk
        v, rid = catalog_topk(q, e, kk, n_items=n_local)
        if row_ids is not None:
            rid = row_ids[rid]
        if exclude is None:  # then kk == k — nothing to re-rank
            return v, rid
        return filter_excluded(v, rid, exclude, k)
    ids = (row_ids if row_ids is not None
           else jnp.arange(e.shape[0], dtype=jnp.int32))
    s = _masked_scores(q, e, jnp.where(ids < cfg.n_items, ids, 0), exclude)
    v, cols = jax.lax.top_k(s, k)
    if row_ids is not None:
        return v, jnp.take_along_axis(
            jnp.broadcast_to(row_ids[None, :], s.shape), cols, axis=1)
    return v, cols


def full_catalog_topk(
    params,
    cfg: ModelConfig,
    profile,
    attrs_table: jnp.ndarray,
    k: int,
    *,
    mesh: Optional[Mesh] = None,
    ctx: Optional[jnp.ndarray] = None,
    exclude: Optional[jnp.ndarray] = None,
    catalog_emb: Optional[jnp.ndarray] = None,
    use_kernel: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k items over the whole catalog: (scores [B,k], item ids [B,k]).

    ``exclude``: optional [B, E] item ids to remove per user (e.g. the
    user's training history for leave-one-out retrieval; 0 entries are
    no-ops). ``catalog_emb``: precomputed ``embed_catalog`` output —
    pass it when evaluating many query batches so the catalog is embedded
    once per sweep, not once per batch (single-device path only; the
    sharded path embeds shard-locally, which is already once per call per
    1/N of the catalog). With a ``mesh`` carrying a ``model`` axis of
    size > 1, the item/attr tables must be row-sharded
    (``pad_table_rows``); queries ride the ``data`` axis; interconnect
    traffic is O(shards · k) per query. ``use_kernel`` routes the
    score+top-k through the tournament kernel (``ops/retrieval_topk.py``)
    — the [B, n_items] score matrix never reaches device memory;
    exclusions are handled by over-retrieving k+E winners and filtering.
    """
    q = queries(params, cfg, profile, attrs_table)
    had_exclude = exclude is not None
    if exclude is None:
        exclude = jnp.zeros((q.shape[0], 1), jnp.int32)
    kk = k + exclude.shape[1] if (use_kernel and had_exclude) else k

    def drop_excluded(v, ids):
        if not had_exclude:
            return v, ids
        return filter_excluded(v, ids, exclude, k)

    if mesh is None or mesh.shape.get("model", 1) == 1:
        from carca_tpu.ops.retrieval_topk import QuantizedIndex
        e = catalog_emb if catalog_emb is not None else embed_catalog(
            params, cfg, attrs_table, ctx,
            global_ids=jnp.arange(attrs_table.shape[0], dtype=jnp.int32))
        return topk_given_queries(
            q, e, cfg, k, exclude=exclude if had_exclude else None,
            use_kernel=use_kernel,
            # a quantized index is decoder-space by construction
            in_decoder_space=isinstance(e, QuantizedIndex))

    has_items = "items" in params["embed"]
    items_table = params["embed"]["items"] if has_items else attrs_table[:, :1]
    if has_items:
        # lane-packed tables (ops/packed_table.py) are row-aligned to the
        # pack factor, not to the attrs shards — unpack (a reshape) and
        # re-align row counts so both tables shard identically
        from carca_tpu.models.embeddings import item_table_width
        from carca_tpu.ops.packed_table import unpack_rows
        w = item_table_width(cfg)
        if items_table.shape[-1] != w:
            items_table = unpack_rows(items_table, w)
        r = attrs_table.shape[0]
        if items_table.shape[0] > r:
            items_table = items_table[:r]
        elif items_table.shape[0] < r:
            items_table = jnp.pad(
                items_table, ((0, r - items_table.shape[0]), (0, 0)))

    def local(attrs_shard, items_shard, q, exclude):
        rows = attrs_shard.shape[0]
        lo = jax.lax.axis_index("model") * rows
        gids = (lo + jnp.arange(rows, dtype=jnp.int32))
        e = catalog_in_decoder_space(embed_catalog(
            params, cfg, attrs_shard, ctx,
            table_rows=items_shard if has_items else None, global_ids=gids), cfg)
        if use_kernel:
            from carca_tpu.ops.retrieval_topk import catalog_topk
            # a shard holds at most `rows` winners: clamping is exact
            v, cand_ids = catalog_topk(q, e, min(kk, rows),
                                       n_items=cfg.n_items, id_offset=lo)
        else:
            mask_ids = jnp.where(gids < cfg.n_items, gids, 0)  # pad rows → 0
            s = _masked_scores(q, e, mask_ids, exclude)
            v, i = jax.lax.top_k(s, kk)
            cand_ids = jnp.take(gids, i)
        av = jax.lax.all_gather(v, "model")  # [shards, b_local, kk]
        ai = jax.lax.all_gather(cand_ids, "model")
        b = q.shape[0]
        av = jnp.transpose(av, (1, 0, 2)).reshape(b, -1)
        ai = jnp.transpose(ai, (1, 0, 2)).reshape(b, -1)
        fv, fi = jax.lax.top_k(av, kk)
        return fv, jnp.take_along_axis(ai, fi, axis=1)

    fv, fi = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("model", None), P("model", None),
                  P("data", None), P("data", None)),
        out_specs=(P("data", None), P("data", None)),
        # outputs ARE replicated over `model` after the all_gather+top_k,
        # but the varying-axes analysis can't prove it through top_k
        check_vma=False,
    )(attrs_table, items_table, q, exclude)
    if use_kernel:
        return drop_excluded(fv, fi)
    return fv, fi


def topk_given_queries_sharded(
    q: jnp.ndarray,
    e,
    cfg: ModelConfig,
    k: int,
    mesh: Mesh,
    *,
    exclude: Optional[jnp.ndarray] = None,
    row_ids: Optional[jnp.ndarray] = None,
    use_kernel: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """`topk_given_queries` over a PRECOMPUTED index row-sharded on the
    ``model`` mesh axis — the serving counterpart of ``full_catalog_topk``'s
    sharded branch (which re-embeds the catalog per call; a serving index
    is embedded once at load time and must stay resident, sharded, in each
    card's memory — e.g. a 100M-row d=64 index that outgrows one card).

    ``e``: [R_pad, d] embeddings or a ``QuantizedIndex``, both already in
    decoder space, with R_pad a multiple of the ``model`` axis size (pad
    rows carry id ≥ cfg.n_items or map to row_ids' pad entries). Queries
    are replicated to every model shard (serving batches are small; the
    index is what's big); each shard streams only its rows and only
    [shards, k+E] candidates cross the interconnect. ``row_ids`` maps compacted index
    rows to global item ids (row 0 = pad, as in ``topk_given_queries``);
    its length is the TRUE index row count — sharding-pad rows beyond it
    are masked by global row index, like the kernel's own pad rows.
    """
    from carca_tpu.ops.retrieval_topk import QuantizedIndex

    quantized = isinstance(e, QuantizedIndex)
    rows = e.rows if quantized else e.shape[0]
    n_shards = mesh.shape["model"]
    if rows % n_shards:
        raise ValueError(
            f"index rows {rows} not divisible by the model axis {n_shards} "
            f"(pad with mesh.pad_table_rows before sharding)")
    # rows beyond the true index (sharding pad) are masked by global row
    # index, exactly like the single-device kernel's internal pad rows
    n_local = (row_ids.shape[0] if row_ids is not None else cfg.n_items)
    if k > min(rows, n_local):
        raise ValueError(
            f"top-k k={k} exceeds the index size {min(rows, n_local)}")
    had_exclude = exclude is not None
    kk = min(k + (exclude.shape[1] if had_exclude else 0), rows)
    local_rows = rows // n_shards
    # a shard holds at most local_rows global winners, so clamping its
    # contribution is exact (the merged pool still covers every candidate)
    kk_local = min(kk, local_rows)

    def local(e_shard, scales_shard, q):
        lo = jax.lax.axis_index("model") * local_rows
        eloc = (QuantizedIndex(e_shard, scales_shard)
                if scales_shard is not None else e_shard)
        if use_kernel:
            from carca_tpu.ops.retrieval_topk import catalog_topk
            v, rid = catalog_topk(q, eloc, kk_local, n_items=n_local,
                                  id_offset=lo)
        else:
            from carca_tpu.ops.retrieval_topk import dequantize_index
            ef = (dequantize_index(eloc) if scales_shard is not None
                  else eloc)
            gids = lo + jnp.arange(local_rows, dtype=jnp.int32)
            s = _masked_scores(
                q, ef, jnp.where(gids < n_local, gids, 0), None)
            v, i = jax.lax.top_k(s, kk_local)
            rid = jnp.take(gids, i)
        av = jax.lax.all_gather(v, "model")  # [shards, B, kk]
        ai = jax.lax.all_gather(rid, "model")
        b = q.shape[0]
        av = jnp.transpose(av, (1, 0, 2)).reshape(b, -1)
        ai = jnp.transpose(ai, (1, 0, 2)).reshape(b, -1)
        fv, fi = jax.lax.top_k(av, kk)
        return fv, jnp.take_along_axis(ai, fi, axis=1)

    if quantized:
        fv, fi = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("model", None), P(None, "model"), P()),
            out_specs=(P(), P()),
            check_vma=False,  # replicated after the all_gather+top_k merge
        )(e.qvals, e.scales, q)
    else:
        fv, fi = jax.shard_map(
            lambda es, qq: local(es, None, qq),
            mesh=mesh,
            in_specs=(P("model", None), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )(e, q)
    if row_ids is not None:
        fi = jnp.where(fv > NEG_INF, row_ids[fi], 0)
    else:
        fi = jnp.where(fv > NEG_INF, fi, 0)
    if had_exclude:
        return filter_excluded(fv, fi, exclude, k)
    return fv, fi


def retrieval_hr_ndcg(
    topk_ids: jnp.ndarray, positives: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batch-sum HR@k and NDCG@k of the held-out positive's rank in the
    full-catalog top-k (same arithmetic as the sampled evaluator,
    ``src/train.py:15-32``)."""
    hit = topk_ids[:, :k] == positives[:, None]  # [B, k]
    any_hit = hit.any(axis=1)
    hr = jnp.sum(any_hit.astype(jnp.float32))
    ranks = jnp.argmax(hit, axis=1)  # first (only) hit position
    gain = 1.0 / jnp.log2(ranks.astype(jnp.float32) + 2.0)
    ndcg = jnp.sum(jnp.where(any_hit, gain, 0.0))
    return hr, ndcg
