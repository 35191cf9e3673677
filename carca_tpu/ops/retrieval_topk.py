"""Exact full-catalog top-k by a group-max tournament.

The XLA retrieval path materializes the ``[B, R]`` score matrix in device
memory: at R = 10M items and B = 256 queries that is 10 GB of f32 written
and read back, against a 1.28 GB bf16 (0.64 GB int8) catalog read. The
tournament keeps only one number per 128-row group:

1. **Stage 1** (``groupmax_kernel``, Pallas on the Triton route): one pass
   over the catalog. Each program scores a ``[BQ, 128]`` tile per loop
   step (query block × one row group), masks pad/out-of-window rows, and
   keeps the tile's row max — the ``[B, R/128]`` group maxima are the only
   output. Blocks are independent (a plain parallel map), so the grid runs
   in any order on the card's SMs.
2. **Stage 2**: ``lax.top_k`` over the group maxima picks ``k + 8`` winner
   groups per query. The union of the top-k groups provably contains the
   true top-k: an element of the true top-k in an unpicked group would
   trail k picked group maxima in (value, first-occurrence) order — k
   elements ahead of a top-k element, a contradiction; ``lax.top_k``'s
   lowest-index tie order makes this exact under ties too.
3. **Stage 3**: the winner groups' rows are re-scored (same dtype and
   precision as stage 1) and top-k'd. Winner groups are sorted ascending
   first, so the final ``lax.top_k``'s first-occurrence tie break matches
   global row order.

Contract: exact top-k under true f32 scores of the (possibly bf16- or
int8-rounded) catalog. bf16 and int8 catalogs round the query to bf16 and
accumulate in f32 (bf16 × bf16 products are exact in f32). f32 catalogs
select with a six-pass bf16 split of the f32 operands (no TF32; within a
few f32 ulps, which the +8 winner-group margin absorbs) and rerank in
true f32.

``groupmax_plain`` is the same stage 1 in plain jnp (a ``lax.map`` over
catalog chunks of ``max((q @ e_chunk.T).reshape(B, -1, 128), -1)``). It is
the kernel's reference in the tests and the other leg of
``scripts/bench_retrieval.py``.

Used by ``carca_tpu.parallel.retrieval`` on the single-device path and per
shard under ``shard_map`` on the row-sharded path (each shard streams only
its rows; the cross-shard merge is an O(shards · k) all-gather).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

NEG_INF = float("-inf")
GROUP = 128  # rows per group maximum
_MARGIN = 8  # extra winner groups: stage-1 and stage-3 sums may differ in ulps
_MIN_DOT = 16  # every operand dim of a Triton dot is >= 16
# kernel blocking: a sweep of chunk 512-2048 × query block 64-256 × 4/8
# warps over the whole top-k at 10M bf16 rows, B=256, k=10 (H100, 700 W)
# spread over 2.27-2.71 ms; these settings are within 1% of the best
_CHUNK, _BLOCK_Q, _NUM_WARPS, _NUM_STAGES = 1024, 128, 4, 3


class QuantizedIndex(NamedTuple):
    """Symmetric per-row int8 catalog index: row r of the f32/bf16
    embedding matrix is ``qvals[r] * scales[0, r]``. Quarters the catalog
    scan vs f32 (halves vs bf16) — the scan is what bounds retrieval
    throughput at multi-million-item catalogs (module docstring). Build
    with ``quantize_index`` AFTER ``catalog_in_decoder_space`` (the scales
    bake in the row geometry, so the transform cannot be applied
    afterwards)."""

    qvals: jnp.ndarray   # [R, d] int8
    scales: jnp.ndarray  # [1, R] float32

    @property
    def rows(self) -> int:
        return self.qvals.shape[0]


def quantize_index(e: jnp.ndarray) -> QuantizedIndex:
    """[R, d] float → per-row symmetric int8 (max-abs scaling).

    An all-zero row (the pad) gets scale 0 and scores exactly 0. Ranking
    error is bounded by the per-element quantization step (≤ max|row|/127
    per coordinate); near-ties may reorder — the serving rerank stage
    re-scores shortlists exactly, and ``tests/test_retrieval.py`` pins the
    end-to-end recall impact."""
    e = e.astype(jnp.float32)
    s = jnp.max(jnp.abs(e), axis=1) / 127.0
    q = jnp.where(s[:, None] > 0, jnp.round(e / jnp.maximum(s, 1e-30)[:, None]), 0.0)
    return QuantizedIndex(
        jnp.clip(q, -127, 127).astype(jnp.int8),
        s.astype(jnp.float32)[None, :])


def dequantize_index(qi: QuantizedIndex) -> jnp.ndarray:
    """Exact float reconstruction of the quantized rows (the XLA path and
    tests score against this)."""
    return qi.qvals.astype(jnp.float32) * qi.scales[0][:, None]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_ceil(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def _compute_dtype(catalog_dtype):
    """bf16 for int8 (exact for |v| ≤ 127) and bf16 catalogs, else f32."""
    return jnp.float32 if catalog_dtype == jnp.float32 else jnp.bfloat16


def _precision(cd):
    # f32: full precision — a TF32 (DEFAULT) dot keeps ~10 mantissa bits,
    # and the contract is top-k under true f32 scores. bf16: DEFAULT (the
    # tensor-core products are exact in the f32 accumulator).
    return (jax.lax.Precision.HIGHEST if cd == jnp.float32
            else jax.lax.Precision.DEFAULT)


def _kernel_precision(cd):
    # In the kernel an f32 dot at HIGHEST is Triton's non-tensor-core
    # "ieee" mode: 285 ms for stage 1 at 10M rows, B=256 (H100). Six bf16
    # tensor-core passes over the split operands (no TF32) track f32 to
    # 3.9e-6 relative there in 5.5 ms; the exact f32 rerank and the
    # +_MARGIN winner groups absorb that.
    return (jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6
            if cd == jnp.float32 else jax.lax.Precision.DEFAULT)


def interpret_mode() -> bool:
    """Whether stage 1 runs through the Pallas interpreter: only on the
    CPU (the tests). The GPU compiles the kernel; any other backend has no
    stage-1 kernel and raises rather than silently interpreting."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise ValueError(f"the retrieval top-k kernel targets the GPU (CPU runs "
                     f"it in interpret mode); no kernel for backend "
                     f"{backend!r}")


def _mask(s, row0, lim):
    """−inf at rows ``row0 + j`` that are pad (global id 0) or beyond the
    valid window. ``lim`` = [n_valid_local, mask_row0] (runtime scalars, so
    a shard's traced offset works)."""
    rows = row0 + jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    bad = (rows >= lim[0]) | ((rows == 0) & (lim[1] == 1))
    return jnp.where(bad, NEG_INF, s)


def _scores(q, e, scales, cd):
    """[B, d] · [n, d]ᵀ → [B, n] f32 under the tournament's contract."""
    s = jnp.einsum("bd,nd->bn", q.astype(cd), e.astype(cd),
                   preferred_element_type=jnp.float32,
                   precision=_precision(cd))
    return s if scales is None else s * scales[None, :]


def _tail_groupmax(q, e, scales, lim, start: int, cd):
    """Group maxima of rows ``start..R`` (fewer than one chunk) in jnp;
    ``start`` is a multiple of GROUP."""
    r = e.shape[0]
    s = _mask(_scores(q, e[start:], None if scales is None else scales[start:],
                      cd), start, lim)
    pad = (-(r - start)) % GROUP
    s = jnp.pad(s, ((0, 0), (0, pad)), constant_values=NEG_INF)
    return jnp.max(s.reshape(q.shape[0], -1, GROUP), axis=2)


def _groupmax_kernel(lim_ref, q_ref, e_ref, *rest, chunk: int, cd):
    """One program: query block i × catalog chunk j → [BQ, chunk/GROUP]
    group maxima. The loop over the chunk's groups keeps one [BQ, GROUP]
    score tile live; Triton pipelines the row-group loads across it."""
    scl_ref, o_ref = rest if len(rest) == 2 else (None, rest[0])
    j = pl.program_id(1)
    q = q_ref[...].astype(cd)  # [BQ, d]
    bq = q.shape[0]
    n_groups = chunk // GROUP
    n_valid, mask_row0 = lim_ref[0], lim_ref[1]
    cols = jax.lax.broadcasted_iota(jnp.int32, (bq, n_groups), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, GROUP), 1)

    def body(g, acc):
        rows = pl.ds(g * GROUP, GROUP)
        e = e_ref[rows, :]
        if e.dtype == jnp.int8:
            e = e.astype(jnp.float32)
        s = pl.dot(q, e.astype(cd), trans_b=True,
                   precision=_kernel_precision(cd))
        if scl_ref is not None:
            s = s * scl_ref[rows][None, :]  # per-row dequantization scales
        gid = j * chunk + g * GROUP + lane
        bad = (gid >= n_valid) | ((gid == 0) & (mask_row0 == 1))
        m = jnp.max(jnp.where(bad, NEG_INF, s), axis=1)
        return jnp.where(cols == g, m[:, None], acc)

    o_ref[...] = jax.lax.fori_loop(
        0, n_groups, body, jnp.full((bq, n_groups), NEG_INF, jnp.float32))


def groupmax_kernel(q, e, scales, lim, *, chunk: int = _CHUNK,
                    block_q: int = _BLOCK_Q) -> jnp.ndarray:
    """Stage 1 through the Pallas kernel → [B, ⌈R/128⌉] group maxima.

    ``q`` [B, d] with B a multiple of ``block_q`` and d a power of two
    ≥ 16 (``catalog_topk`` pads both); ``e`` [R, d]; ``scales`` [R] or
    None. The grid covers the catalog's whole chunks; the < ``chunk``
    tail rows are scored in jnp and written into the same output."""
    b, d = q.shape
    r = e.shape[0]
    cd = _compute_dtype(e.dtype)
    n_full = r // chunk
    n_groups = -(-r // GROUP)
    if n_full == 0:
        return _tail_groupmax(q, e, scales, lim, 0, cd)
    in_specs = [
        pl.BlockSpec((2,), lambda i, j: (0,)),
        pl.BlockSpec((block_q, d), lambda i, j: (i, 0)),
        pl.BlockSpec((chunk, d), lambda i, j: (j, 0)),
    ]
    args = [lim, q, e]
    if scales is not None:
        in_specs.append(pl.BlockSpec((chunk,), lambda i, j: (j,)))
        args.append(scales)
    gm = pl.pallas_call(
        functools.partial(_groupmax_kernel, chunk=chunk, cd=cd),
        # query blocks innermost: the programs that share a catalog chunk
        # run back to back, so its second read comes from L2
        grid=(b // block_q, n_full),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((block_q, chunk // GROUP), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((b, n_groups), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=_NUM_STAGES),
        interpret=interpret_mode(),
        name="retrieval_groupmax",
    )(*args)
    if n_full * chunk < r:
        start = n_full * chunk
        gm = jax.lax.dynamic_update_slice(
            gm, _tail_groupmax(q, e, scales, lim, start, cd),
            (0, start // GROUP))
    return gm


def groupmax_plain(q, e, scales, lim, *, chunk: int = 1 << 16) -> jnp.ndarray:
    """Stage 1 in plain jnp, left to XLA → [B, ⌈R/128⌉] group maxima:
    ``max((q @ e_chunk.T).reshape(B, -1, 128), -1)`` over whole chunks
    under ``lax.map``, then the tail. Each chunk's [B, chunk] scores go
    through device memory."""
    b = q.shape[0]
    r = e.shape[0]
    cd = _compute_dtype(e.dtype)
    chunk = min(chunk, _round_up(r, GROUP))
    n_full = r // chunk
    parts = []
    if n_full:
        def one(c):
            start = c * chunk
            ec = jax.lax.dynamic_slice_in_dim(e, start, chunk)
            sc = (None if scales is None
                  else jax.lax.dynamic_slice_in_dim(scales, start, chunk))
            s = _mask(_scores(q, ec, sc, cd), start, lim)
            return jnp.max(s.reshape(b, -1, GROUP), axis=2)

        gm = jax.lax.map(one, jnp.arange(n_full))  # [n, B, chunk/128]
        parts.append(jnp.moveaxis(gm, 0, 1).reshape(b, -1))
    if n_full * chunk < r:
        parts.append(_tail_groupmax(q, e, scales, lim, n_full * chunk, cd))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


def _rerank(q, e, scales, gi, k: int, lim):
    """Stage 3: re-score the winner groups' rows ([B, kg] sorted group
    ids) exactly and top-k them → (values [B, k], local rows [B, k])."""
    b = q.shape[0]
    r, d = e.shape
    kg = gi.shape[1]
    cd = _compute_dtype(e.dtype)
    # f32 arithmetic on the rounded operands, as an explicit multiply +
    # sum. Measured on the GPU: a dot of two bf16→f32 converts is folded
    # into a bf16 dot with its result rounded to bf16, and a plain
    # f32→bf16→f32 round trip of the query is elided as "excess
    # precision" — both off by ~2^-9 relative. reduce_precision is the
    # rounding XLA keeps.
    qc = q.astype(jnp.float32)
    if cd == jnp.bfloat16:
        qc = jax.lax.reduce_precision(qc, exponent_bits=8, mantissa_bits=7)
    # memory-bounded slices: the gathered rows are [B, kc·GROUP, d]
    slice_bytes = b * GROUP * d * e.dtype.itemsize
    kc = max(1, min(kg, (128 << 20) // max(slice_bytes, 1)))
    ns = -(-kg // kc)
    gi_p = jnp.pad(gi, ((0, 0), (0, ns * kc - kg)))  # dup-padded; masked below
    lanes = jnp.arange(GROUP, dtype=jnp.int32)

    def score_slice(gis):  # [B, kc] group ids → [B, kc·GROUP] scores
        rows = (gis[:, :, None] * GROUP + lanes).reshape(b, -1)
        safe = jnp.minimum(rows, r - 1)
        s = jnp.sum(qc[:, None, :] * e[safe].astype(jnp.float32), axis=-1)
        return s if scales is None else s * scales[safe]

    if ns == 1:
        s2 = score_slice(gi_p)
    else:
        s2 = jax.lax.map(score_slice,
                         jnp.moveaxis(gi_p.reshape(b, ns, kc), 1, 0))
        s2 = jnp.moveaxis(s2, 0, 1).reshape(b, ns * kc * GROUP)
    rows = (gi_p[:, :, None] * GROUP + lanes).reshape(b, -1)
    pad_slot = jnp.repeat(jnp.arange(ns * kc) >= kg, GROUP)[None, :]
    bad = pad_slot | (rows >= lim[0]) | ((rows == 0) & (lim[1] == 1))
    v, sel = jax.lax.top_k(jnp.where(bad, NEG_INF, s2), k)
    return v, jnp.take_along_axis(rows, sel, axis=1)


def catalog_topk(
    q: jnp.ndarray,
    catalog_emb: Union[jnp.ndarray, QuantizedIndex],
    k: int,
    *,
    n_items: Optional[int] = None,
    id_offset=0,
    kernel: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(values [B,k], global item ids [B,k]) = top-k of q · catalog_embᵀ.

    ``catalog_emb`` [R, d] are rows ``id_offset .. id_offset+R``; rows whose
    global id is 0 (pad) or ≥ ``n_items`` are excluded. ``id_offset`` may be
    a traced scalar (shard_map axis offset). Scores follow the dot decoder's
    eval geometry (``src/carca.py:362``); apply sigmoid outside if
    calibrated probabilities are needed (monotonic → same ranks).

    A bf16 ``catalog_emb`` halves the catalog scan and a ``QuantizedIndex``
    quarters it (int8 rows + per-row scales); queries are then rounded to
    bf16 (module docstring). ``kernel=False`` runs stage 1 in plain jnp
    (``groupmax_plain``) — the reference the kernel is measured against.

    The kernel wants query blocks of ≥ 16 rows and a power-of-two width
    ≥ 16: smaller batches are padded (cheap), and an odd width pads the
    catalog's columns (a copy — model widths 64/128 need none).
    """
    scales = None
    if isinstance(catalog_emb, QuantizedIndex):
        catalog_emb, scales = catalog_emb.qvals, catalog_emb.scales[0]
    b, d = q.shape
    r = catalog_emb.shape[0]
    if not 1 <= k <= r:
        raise ValueError(f"top-k k={k} must lie in [1, {r}] (the catalog "
                         f"slice's rows)")
    n_items = n_items if n_items is not None else id_offset + r
    # the kernel works in local row space (0..R); the valid-row window and
    # the pad-row mask are shifted by id_offset. The window is clamped to
    # this slice's real row count: on a non-last shard n_items - id_offset
    # exceeds r
    id_offset = jnp.asarray(id_offset, jnp.int32)
    lim = jnp.stack([jnp.minimum(jnp.asarray(n_items, jnp.int32) - id_offset,
                                 jnp.asarray(r, jnp.int32)),
                     (id_offset == 0).astype(jnp.int32)])
    if kernel:
        dp = max(_MIN_DOT, _pow2_ceil(d))
        bq = min(_BLOCK_Q, max(_MIN_DOT, _pow2_ceil(b)))
        bp = _round_up(b, bq)
        qk = jnp.pad(q, ((0, bp - b), (0, dp - d)))
        ek = (catalog_emb if dp == d
              else jnp.pad(catalog_emb, ((0, 0), (0, dp - d))))
        # a power-of-two chunk ≤ R (≥ one group): small catalogs still
        # get a kernel grid, the rest is the jnp tail
        c = max(GROUP, min(_CHUNK, _pow2_floor(max(r, 1))))
        gm = groupmax_kernel(qk, ek, scales, lim, chunk=c, block_q=bq)
        gm = gm if bp == b else gm[:b]
    else:
        gm = groupmax_plain(q, catalog_emb, scales, lim)
    kg = min(k + _MARGIN, gm.shape[1])
    _, gi = jax.lax.top_k(gm, kg)      # ties → lowest group id first
    gi = jnp.sort(gi, axis=1)          # restore global row order
    v, rows = _rerank(q, catalog_emb, scales, gi, k, lim)
    # rows are local (0-based over this slice); shift to global ids,
    # mapping fully-masked slots (v == −inf) to the pad id 0
    return v, jnp.where(v > NEG_INF, rows + id_offset, 0)
