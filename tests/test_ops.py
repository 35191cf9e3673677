"""Retrieval top-k kernel (ops/retrieval_topk.py) on the CPU: the Pallas
stage-1 kernel in interpret mode against the plain-jnp stage 1, the
kernel tournament against ``lax.top_k``, the wrapper's padding and block
choice, and its backend guard. One ``gpu``-marked test runs the compiled
kernel on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.ops import retrieval_topk as rt
from carca_tpu.ops.retrieval_topk import (catalog_topk, dequantize_index,
                                          groupmax_kernel, groupmax_plain,
                                          quantize_index)


def _catalog(dtype, r, d, seed):
    e = jnp.asarray(np.random.default_rng(seed).normal(size=(r, d)),
                    jnp.float32)
    if dtype == "int8":
        qi = quantize_index(e)
        return qi.qvals, qi.scales[0]
    return e.astype(dtype), None


def _brute(q, e, scales, k, off=0, n_items=None):
    """lax.top_k over exact f32 scores of the (rounded) catalog under the
    kernel's contract (bf16-rounded queries for bf16/int8 catalogs)."""
    if e.dtype != jnp.float32:
        q = q.astype(jnp.bfloat16)
    s = np.asarray(q.astype(jnp.float32)) @ np.asarray(
        e.astype(jnp.float32)).T
    if scales is not None:
        s = s * np.asarray(scales)[None, :]
    r = e.shape[0]
    rows = np.arange(r) + off
    s[:, (rows == 0) | (rows >= (n_items or off + r))] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, axis=1), order + off


@pytest.mark.parametrize("rows", [1000, 2048 + 77])
@pytest.mark.parametrize("id_offset", [0, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_stage1_kernel_matches_plain(dtype, id_offset, rows):
    """Stage-1 group maxima: kernel (interpret mode) ≡ plain jnp, for each
    catalog dtype, shard offset and a catalog that is not a whole number
    of chunks (the tail rows go through the jnp tail path)."""
    e, scales = _catalog(dtype, rows, 32, seed=rows)
    q = jax.random.normal(jax.random.PRNGKey(0), (16, 32))
    n_items = id_offset + rows - 5  # a few rows beyond the valid window
    lim = jnp.array([n_items - id_offset, int(id_offset == 0)], jnp.int32)
    gk = groupmax_kernel(q, e, scales, lim, chunk=512, block_q=16)
    gp = groupmax_plain(q, e, scales, lim, chunk=256)
    assert gk.shape == gp.shape == (16, -(-rows // 128))
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gp),
                               rtol=1e-5, atol=1e-5)
    if id_offset == 0:  # the pad row is masked, the next row is not
        assert np.isfinite(np.asarray(gk)[:, 0]).all()


@pytest.mark.parametrize("k", [1, 10, 60])
def test_kernel_tournament_matches_lax_topk(k):
    rng = np.random.default_rng(k)
    r, b, d = 3000, 8, 16
    q = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
    e = jnp.asarray(rng.normal(size=(r, d)), jnp.float32)
    v, ids = catalog_topk(q, e, k)
    bv, bi = _brute(q, e, None, k)
    np.testing.assert_allclose(np.asarray(v), bv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), bi)


def test_kernel_tournament_exact_under_ties():
    """Integer scores (exact in f32) with many duplicates straddling group
    boundaries: first-occurrence order must match lax.top_k exactly."""
    rng = np.random.default_rng(11)
    e = jnp.asarray(rng.integers(0, 3, (1500, 16)), jnp.float32)
    q = jnp.asarray(rng.integers(0, 3, (6, 16)), jnp.float32)
    for kernel in (True, False):
        v, ids = catalog_topk(q, e, 40, kernel=kernel)
        bv, bi = _brute(q, e, None, 40)
        np.testing.assert_array_equal(np.asarray(v), bv)
        np.testing.assert_array_equal(np.asarray(ids), bi)


@pytest.mark.parametrize("b,r,d", [(1, 300, 16), (20, 1000, 64),
                                   (130, 2049, 24)])
def test_wrapper_pads_batch_and_width(b, r, d, monkeypatch):
    """B and R that are not multiples of the block, and a width that is
    not a power of two: the wrapper pads the queries to whole ≥16-row
    blocks and the width to a power of two ≥ 16, picks a power-of-two
    chunk ≤ R, and the padding never leaks into the results."""
    seen = {}
    real = rt.groupmax_kernel

    def spy(q, e, scales, lim, **kw):
        seen.update(shape=q.shape, width=e.shape[1], **kw)
        return real(q, e, scales, lim, **kw)

    monkeypatch.setattr(rt, "groupmax_kernel", spy)
    rng = np.random.default_rng(b)
    q = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
    e = jnp.asarray(rng.normal(size=(r, d)), jnp.float32)
    v, ids = catalog_topk(q, e, 5)
    bq, chunk = seen["block_q"], seen["chunk"]
    assert bq & (bq - 1) == 0 and 16 <= bq <= 128
    assert seen["shape"][0] % bq == 0 and seen["shape"][0] >= b
    w = seen["width"]
    assert w >= max(d, 16) and w & (w - 1) == 0
    assert chunk & (chunk - 1) == 0 and 128 <= chunk <= max(r, 128)
    assert v.shape == ids.shape == (b, 5)
    bv, bi = _brute(q, e, None, 5)
    np.testing.assert_allclose(np.asarray(v), bv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), bi)


def test_backend_guard_raises_on_unknown_backend(monkeypatch):
    """Interpret mode only on the CPU, compiled on the GPU, and no silent
    interpreter anywhere else."""
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert rt.interpret_mode() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert rt.interpret_mode() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="no kernel for backend 'rocm'"):
        rt.interpret_mode()


def test_catalog_topk_k_exceeding_rows_raises():
    q = jnp.zeros((4, 16))
    e = jnp.zeros((100, 16))
    with pytest.raises(ValueError, match=r"k=101 must lie in \[1, 100\]"):
        catalog_topk(q, e, 101)


def test_quantized_index_roundtrip_and_pad_row():
    e = jnp.asarray(np.random.default_rng(3).normal(size=(50, 16)),
                    jnp.float32).at[0].set(0.0)
    qi = quantize_index(e)
    assert qi.qvals.dtype == jnp.int8 and qi.scales.shape == (1, 50)
    deq = dequantize_index(qi)
    assert float(jnp.max(jnp.abs(deq[0]))) == 0.0  # pad row scores 0
    step = np.asarray(jnp.max(jnp.abs(e), axis=1) / 127.0)[:, None]
    assert (np.abs(np.asarray(deq - e)) <= step / 2 + 1e-7).all()


def test_catalog_topk_shard_slice_pad_rows_masked():
    """Regression: a non-last shard's kernel-side zero-pad rows [r, rp)
    entered the top-k with fabricated score 0 under the NEXT shard's ids
    whenever all real scores were negative (cosine decoders, exclusion
    tails)."""
    rng = np.random.default_rng(0)
    q = jnp.asarray(np.abs(rng.normal(size=(4, 16))) + 0.1, jnp.float32)
    e = jnp.asarray(-np.abs(rng.normal(size=(130, 16))) - 1.0, jnp.float32)
    # simulate shard 1 of many: rows are ids 1000..1129 of a 5000-id catalog
    v, ids = catalog_topk(q, e, 5, n_items=5000, id_offset=1000)
    ids = np.asarray(ids)
    assert (ids < 1130).all(), f"phantom pad-row ids returned: {ids}"
    assert np.isfinite(np.asarray(v)).all()
    # scores must be genuinely negative (no fabricated zeros)
    assert (np.asarray(v) < 0).all()


def test_mha_apply_raises_without_rng():
    """Train-mode dropout without a key is an error, never a silent
    dropout-free step."""
    from carca_tpu.models.attention import mha_apply, mha_init

    params = mha_init(jax.random.PRNGKey(0), 16)
    x = jnp.ones((2, 4, 16))
    m = jnp.ones((2, 4))
    with pytest.raises(ValueError, match="rng"):
        mha_apply(params, x, x, x, m, m, n_heads=2, causal=0,
                  dropout_rate=0.5, train=True, rng=None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_compiled_kernel_matches_plain_on_gpu(gpu, dtype):
    """The compiled (non-interpret) kernel against the plain stage 1 on
    the card, at the model width."""
    e, scales = _catalog(dtype, 100_003, 64, seed=1)
    q = jax.random.normal(jax.random.PRNGKey(0), (256, 64))
    lim = jnp.array([100_003, 1], jnp.int32)
    gk = groupmax_kernel(q, e, scales, lim)
    gp = groupmax_plain(q, e, scales, lim)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gp),
                               rtol=1e-5, atol=1e-4)
