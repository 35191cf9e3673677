"""Full-catalog retrieval: sharded top-k must equal the single-device
brute-force ranking exactly (values and ids), and the HR/NDCG arithmetic
must match the sampled evaluator's formulas (src/train.py:15-32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.config import ModelConfig
from carca_tpu.data.synthetic import synthetic_catalog
from carca_tpu.models.carca import carca_init
from carca_tpu.parallel.mesh import make_mesh, pad_table_rows
from carca_tpu.parallel.retrieval import (embed_catalog, full_catalog_topk,
                                          retrieval_hr_ndcg)
from tests.conftest import skip_unless_devices


@pytest.fixture(scope="module", params=["dot", "wdot"])
def setup(request):
    cat = synthetic_catalog(n_users=40, n_real_items=111, seed=11)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=8, target_len=10, n_blocks=2,
                     n_heads=2, dropout=0.0, embedding="all",
                     decoder=request.param)
    params = carca_init(jax.random.PRNGKey(0), mc)
    rng = np.random.default_rng(0)
    b = 8
    p_x = jnp.asarray(rng.integers(0, mc.n_items, (b, mc.seq_len)), jnp.int32)
    p_c = jnp.asarray(rng.normal(size=(b, mc.seq_len, mc.n_ctx)), jnp.float32)
    attrs = jnp.asarray(cat.attrs)
    return mc, params, (p_x, None, p_c), attrs


def test_sharded_topk_matches_single_device(setup):
    skip_unless_devices(8)
    mc, params, profile, attrs = setup
    k = 10
    v0, i0 = full_catalog_topk(params, mc, profile, attrs, k)

    mesh = make_mesh((2, 4), ("data", "model"))
    attrs_p = jnp.asarray(pad_table_rows(np.asarray(attrs), mesh))
    params_p = dict(params, embed=dict(
        params["embed"],
        items=jnp.asarray(pad_table_rows(
            np.asarray(params["embed"]["items"]), mesh))))
    v1, i1 = full_catalog_topk(params_p, mc, profile, attrs_p, k, mesh=mesh)

    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_topk_matches_bruteforce_and_excludes(setup):
    mc, params, profile, attrs = setup
    k = 5
    exclude = jnp.asarray(
        np.random.default_rng(1).integers(1, mc.n_items, (8, 4)), jnp.int32)
    v, ids = full_catalog_topk(params, mc, profile, attrs, k, exclude=exclude)

    from carca_tpu.parallel.retrieval import queries
    q = queries(params, mc, profile, attrs)
    e = embed_catalog(params, mc, attrs)
    s = np.array(jnp.einsum("bd,rd->br", q, e))
    s[:, 0] = -np.inf
    for b in range(8):
        s[b, np.asarray(exclude[b])] = -np.inf
        order = np.argsort(-s[b], kind="stable")[:k]
        np.testing.assert_allclose(np.asarray(v[b]), s[b][order], rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(ids[b]), order)
        assert not np.isin(np.asarray(ids[b]), np.asarray(exclude[b])).any()
        assert 0 not in np.asarray(ids[b])


def test_retrieval_hr_ndcg_formula():
    # positive at rank 0, rank 3, and absent
    topk = jnp.asarray([[7, 2, 3], [5, 6, 7], [1, 2, 3]], jnp.int32)
    pos = jnp.asarray([7, 7, 9], jnp.int32)
    hr, ndcg = retrieval_hr_ndcg(topk, pos, k=3)
    assert float(hr) == 2.0
    want = 1.0 / np.log2(0 + 2) + 1.0 / np.log2(2 + 2)
    np.testing.assert_allclose(float(ndcg), want, rtol=1e-6)


def test_kernel_topk_matches_lax_topk():
    """Kernel tournament ≡ jax.lax.top_k over several shapes/offsets."""
    from carca_tpu.ops.retrieval_topk import catalog_topk
    rng = np.random.default_rng(3)
    for r, b, d, k, off in [(500, 8, 16, 10, 0), (1000, 4, 32, 7, 0),
                            (300, 8, 16, 5, 300)]:
        q = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
        e = jnp.asarray(rng.normal(size=(r, d)), jnp.float32)
        v, ids = catalog_topk(q, e, k, n_items=off + r, id_offset=off)
        s = np.array(jnp.einsum("bd,rd->br", q, e))
        if off == 0:
            s[:, 0] = -np.inf  # pad id
        for bi in range(b):
            order = np.argsort(-s[bi], kind="stable")[:k]
            np.testing.assert_allclose(np.asarray(v[bi]), s[bi][order],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(ids[bi]), order + off)


def test_tournament_topk_matches_lax_topk():
    """Tournament ≡ jax.lax.top_k: values, ids, and tie order, with and
    without shard offsets, including catalogs that are not multiples of
    the group width; int8 against the dequantized brute force."""
    from carca_tpu.ops.retrieval_topk import catalog_topk, quantize_index
    rng = np.random.default_rng(7)
    for r, b, d, k, off in [(1000, 8, 16, 10, 0), (517, 4, 32, 7, 0),
                            (777, 8, 16, 5, 777), (4096, 4, 16, 12, 0)]:
        q = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
        e = jnp.asarray(rng.normal(size=(r, d)), jnp.float32)
        v, ids = catalog_topk(q, e, k, n_items=off + r, id_offset=off)
        s = np.array(jnp.einsum("bd,rd->br", q, e))
        if off == 0:
            s[:, 0] = -np.inf  # pad id
        for bi in range(b):
            order = np.argsort(-s[bi], kind="stable")[:k]
            np.testing.assert_allclose(np.asarray(v[bi]), s[bi][order],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(ids[bi]), order + off)

    # quantized index: exact f32-accumulated scores of the int8 rows
    from carca_tpu.ops.retrieval_topk import dequantize_index
    e = jnp.asarray(rng.normal(size=(900, 16)), jnp.float32)
    q = jnp.asarray(rng.normal(size=(4, 16)), jnp.float32)
    qi = quantize_index(e)
    v, ids = catalog_topk(q, qi, 9)
    sd = np.array(jnp.einsum(
        "bd,rd->br", q.astype(jnp.bfloat16),
        qi.qvals.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32) * qi.scales[0][None, :])
    sd[:, 0] = -np.inf
    for bi in range(4):
        order = np.argsort(-sd[bi], kind="stable")[:9]
        np.testing.assert_allclose(np.asarray(v[bi]), sd[bi][order],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(ids[bi]), order)


def test_tournament_topk_exact_under_ties():
    """Crafted cross-group ties: integer-valued scores exact in f32, many
    duplicates straddling group boundaries — tournament must reproduce
    lax.top_k's first-occurrence order exactly."""
    from carca_tpu.ops.retrieval_topk import catalog_topk
    rng = np.random.default_rng(11)
    r, d, b, k = 1500, 4, 6, 8
    # embeddings whose dots take few distinct integer values → heavy ties
    e = jnp.asarray(rng.integers(0, 3, (r, d)), jnp.float32)
    q = jnp.asarray(rng.integers(0, 3, (b, d)), jnp.float32)
    v, ids = catalog_topk(q, e, k)
    s = np.array(np.asarray(q) @ np.asarray(e).T)
    s[:, 0] = -np.inf
    for bi in range(b):
        order = np.argsort(-s[bi], kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(v[bi]), s[bi][order])
        np.testing.assert_array_equal(np.asarray(ids[bi]), order)


def test_tournament_topk_tiny_batch():
    """Batches below the kernel's 16-row minimum block (carca-serve's
    batch-1 bucket) are padded inside the wrapper; values/ids must be
    exact and the padded rows must not leak out."""
    from carca_tpu.ops.retrieval_topk import catalog_topk, quantize_index
    rng = np.random.default_rng(9)
    e = jnp.asarray(rng.normal(size=(700, 16)), jnp.float32)
    qi = quantize_index(e)
    sd = None
    for b in (1, 3, 7):
        q = jnp.asarray(rng.normal(size=(b, 16)), jnp.float32)
        v, ids = catalog_topk(q, qi, 6)
        assert v.shape == (b, 6) and ids.shape == (b, 6)
        sd = np.array(jnp.einsum(
            "bd,rd->br", q.astype(jnp.bfloat16),
            qi.qvals.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32) * qi.scales[0][None, :])
        sd[:, 0] = -np.inf
        for bi in range(b):
            order = np.argsort(-sd[bi], kind="stable")[:6]
            np.testing.assert_allclose(np.asarray(v[bi]), sd[bi][order],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(ids[bi]), order)
        # f32 catalog too
        vf, idf = catalog_topk(q, e, 6)
        s = np.array(np.asarray(q) @ np.asarray(e).T)
        s[:, 0] = -np.inf
        for bi in range(b):
            order = np.argsort(-s[bi], kind="stable")[:6]
            np.testing.assert_array_equal(np.asarray(idf[bi]), order)


def test_tournament_topk_huge_batch_single_chunk():
    """A query batch far beyond one block (4096 rows = 32 blocks of 128)
    over a catalog of about one chunk: every block sees the same chunk
    and tail, and every row's result is exact."""
    from carca_tpu.ops.retrieval_topk import catalog_topk
    rng = np.random.default_rng(3)
    b, r, d, k = 4096, 300, 8, 5
    q = jnp.asarray(rng.normal(size=(b, d)), jnp.float32)
    e = jnp.asarray(rng.normal(size=(r, d)), jnp.float32)
    v, ids = catalog_topk(q, e, k)
    s = np.array(np.asarray(q) @ np.asarray(e).T)
    s[:, 0] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(np.asarray(v),
                               np.take_along_axis(s, order, axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids), order)


def test_tournament_topk_sharded_and_in_pipeline(setup):
    """The kernel tournament slots into topk_given_queries (exclusions
    over-retrieved and filtered) with identical results to the XLA
    path."""
    mc, params, profile, attrs = setup
    from carca_tpu.parallel.retrieval import queries, topk_given_queries
    q = queries(params, mc, profile, attrs)
    e = embed_catalog(params, mc, attrs)
    exclude = jnp.asarray(
        np.random.default_rng(5).integers(1, mc.n_items, (8, 4)), jnp.int32)
    v0, i0 = topk_given_queries(q, e, mc, 6, exclude=exclude,
                                use_kernel=False)
    v1, i1 = topk_given_queries(q, e, mc, 6, exclude=exclude)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_full_catalog_topk_kernel_equals_xla(setup):
    mc, params, profile, attrs = setup
    k = 10
    exclude = jnp.asarray(
        np.random.default_rng(4).integers(1, mc.n_items, (8, 5)), jnp.int32)
    v0, i0 = full_catalog_topk(params, mc, profile, attrs, k,
                               exclude=exclude, use_kernel=False)
    v1, i1 = full_catalog_topk(params, mc, profile, attrs, k,
                               exclude=exclude, use_kernel=True)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_sharded_kernel_topk_matches_single_device(setup):
    skip_unless_devices(8)
    mc, params, profile, attrs = setup
    k = 6
    v0, i0 = full_catalog_topk(params, mc, profile, attrs, k, use_kernel=True)
    mesh = make_mesh((2, 4), ("data", "model"))
    attrs_p = jnp.asarray(pad_table_rows(np.asarray(attrs), mesh))
    params_p = dict(params, embed=dict(
        params["embed"],
        items=jnp.asarray(pad_table_rows(
            np.asarray(params["embed"]["items"]), mesh))))
    v1, i1 = full_catalog_topk(params_p, mc, profile, attrs_p, k, mesh=mesh,
                               use_kernel=True)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))


def test_embed_catalog_chunked_matches_unchunked(setup):
    mc, params, _, attrs = setup
    e0 = embed_catalog(params, mc, attrs)
    e1 = embed_catalog(params, mc, attrs, row_chunk=37)  # ragged chunking
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e0),
                               rtol=1e-6, atol=1e-6)


def test_evaluate_retrieval_end_to_end(tmp_path):
    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.train.loop import evaluate_retrieval, fit

    cat = synthetic_catalog(n_users=150, n_real_items=120, seed=4)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="dot")
    cfg = Config(model=mc, data=DataConfig(synthetic=True),
                 train=TrainConfig(batch_size=32, epochs=1, early_stop=3,
                                   out_dir=str(tmp_path), seed=0))
    state, _ = fit(cfg, cat, log=False)
    out = evaluate_retrieval(cfg, cat, state.params, mode="test", k=10,
                             log=False)
    assert 0.0 <= out["retrieval_test_hr"] <= 1.0
    assert 0.0 <= out["retrieval_test_ndcg"] <= 1.0

    # the int8-index measurement path (quantized=True) must run end-to-end
    # and stay close to the float ranking on a trained model
    outq = evaluate_retrieval(cfg, cat, state.params, mode="test", k=10,
                              log=False, quantized=True)
    assert abs(outq["retrieval_test_hr"] - out["retrieval_test_hr"]) <= 0.05
    assert 0.0 <= outq["retrieval_test_ndcg"] <= 1.0

    import pytest as _pytest
    cfg_ca = Config(model=ModelConfig(
        n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
        d=16, g=32, seq_len=6, decoder="ca"))
    with _pytest.raises(ValueError):
        evaluate_retrieval(cfg_ca, cat, state.params)


def test_eval_retrieval_every_monitors_during_fit(tmp_path):
    """TrainConfig.eval_retrieval_every runs the full-catalog retrieval
    eval (val split) every N-th epoch inside fit and logs the curve to
    metrics.jsonl (docs/DESIGN.md §11: the sampled val eval is blind to
    the retrieval regime, so retrieval deployments monitor this
    directly). No reference counterpart — its eval always samples 100
    negatives (src/data.py:140-192)."""
    import json as _json

    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig

    cat = synthetic_catalog(n_users=150, n_real_items=120, seed=4)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="dot")
    cfg = Config(model=mc, data=DataConfig(synthetic=True),
                 train=TrainConfig(batch_size=32, epochs=2, early_stop=5,
                                   out_dir=str(tmp_path), seed=0, verbose=0,
                                   eval_retrieval_every=1))
    from carca_tpu.train.loop import fit
    _, final = fit(cfg, cat, log=True)
    assert 0.0 <= final["retrieval_val_hr"] <= 1.0
    assert 0.0 <= final["retrieval_val_ndcg"] <= 1.0
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [_json.loads(line) for line in f]
    rrows = [r for r in rows if "retrieval_val_hr" in r]
    assert [r["epoch"] for r in rrows] == [1, 2]

    # ca decoder: monitoring is skipped with a note, not an error
    cfg_ca = Config(
        model=ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                          n_ctx=cat.n_ctx, d=16, g=32, seq_len=6,
                          target_len=8, n_blocks=1, n_heads=2, decoder="ca"),
        data=DataConfig(synthetic=True),
        train=TrainConfig(batch_size=32, epochs=1, early_stop=5,
                          out_dir=str(tmp_path / "ca"), seed=0, verbose=0,
                          eval_retrieval_every=1))
    _, final_ca = fit(cfg_ca, cat, log=False)
    assert "retrieval_val_hr" not in final_ca


def test_select_by_retrieval_retains_peak_epoch(tmp_path):
    """select_by=retrieval_hr keys best-checkpoint retention on the
    monitored full-catalog metric: the retained epoch must be the first
    argmax of the logged retrieval_val_hr curve (strict-improvement
    semantics), not the sampled-NDCG peak. config.py rationale: at
    extreme sparsity the two curves disagree violently (DESIGN §11)."""
    import json as _json

    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.train.checkpoint import CheckpointKeeper
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=150, n_real_items=120, seed=4)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="dot")
    cfg = Config(model=mc, data=DataConfig(synthetic=True),
                 train=TrainConfig(batch_size=32, epochs=3, early_stop=5,
                                   out_dir=str(tmp_path), seed=0, verbose=0,
                                   eval_retrieval_every=1,
                                   select_by="retrieval_hr"))
    fit(cfg, cat, log=True)
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [_json.loads(line) for line in f]
    curve = {r["epoch"]: r["retrieval_val_hr"] for r in rows
             if "retrieval_val_hr" in r}
    assert len(curve) == 3
    peak_epoch = max(sorted(curve), key=lambda e: (curve[e], -e))
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    try:
        m = keeper.best_metrics()
    finally:
        keeper.close()
    assert m["select_by"] == "retrieval_hr"
    assert m["epoch"] == peak_epoch
    assert m["select"] == curve[peak_epoch]

    # misconfiguration: retrieval selection without monitoring must raise
    import pytest as _pytest
    bad = Config(model=mc, data=DataConfig(synthetic=True),
                 train=TrainConfig(batch_size=32, epochs=1,
                                   out_dir=str(tmp_path / "x"),
                                   select_by="retrieval_hr"))
    with _pytest.raises(ValueError, match="eval_retrieval_every"):
        fit(bad, cat, log=False)


def test_topk_rejects_k_beyond_catalog(setup):
    mc, params, profile, attrs = setup
    from carca_tpu.parallel.retrieval import (catalog_in_decoder_space,
                                              queries, topk_given_queries)
    q = queries(params, mc, profile, attrs)
    e = embed_catalog(params, mc, attrs)
    with pytest.raises(ValueError, match="exceeds the catalog"):
        topk_given_queries(q, e, mc, e.shape[0] + 1)
    # a pre-normalized catalog (serving path) must rank identically
    v1, i1 = topk_given_queries(q, e, mc, 5)
    v2, i2 = topk_given_queries(q, catalog_in_decoder_space(e, mc), mc, 5,
                                in_decoder_space=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6)


def test_catalog_topk_large_query_batch():
    """A query batch of several kernel blocks (1024 = 8 × 128): every
    block's group maxima land in their own output rows."""
    from carca_tpu.ops.retrieval_topk import catalog_topk

    b, n = 1024, 4096
    q = jax.random.normal(jax.random.PRNGKey(0), (b, 16))
    e = jax.random.normal(jax.random.PRNGKey(1), (n, 16))
    v, ids = catalog_topk(q, e, 5, n_items=n)
    scores = (q @ e.T).at[:, 0].set(-jnp.inf)
    ov, oi = jax.lax.top_k(scores, 5)
    np.testing.assert_allclose(np.asarray(v), np.asarray(ov), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(oi))


def test_seen_only_index_matches_full_on_covered_catalog():
    """When every item appears in training, the seen-only index is the full
    catalog — metrics must agree exactly; with most items unseen, the
    compacted index must return only seen ids."""
    from carca_tpu.config import Config, TrainConfig
    from carca_tpu.models.carca import carca_init
    from carca_tpu.train.loop import evaluate_retrieval

    cat = synthetic_catalog(n_users=300, n_real_items=80, seed=4)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=10,
                     n_blocks=1, n_heads=2, dropout=0.0, decoder="dot")
    cfg = Config(model=mc, train=TrainConfig(batch_size=32))
    params = carca_init(jax.random.PRNGKey(0), mc)
    full = evaluate_retrieval(cfg, cat, params, log=False, seen_only=False)
    seen = evaluate_retrieval(cfg, cat, params, log=False, seen_only=True)
    ev = np.bincount(np.asarray(cat.items), minlength=cat.n_items)
    if (ev[1:] > 0).all():  # fully covered catalog → identical metrics
        for key in full:
            np.testing.assert_allclose(seen[key], full[key], atol=1e-6)


def test_seen_only_index_excludes_unseen_items():
    from carca_tpu.config import Config, TrainConfig
    from carca_tpu.data.device_pipeline import DeviceDataset
    from carca_tpu.models.carca import carca_init
    from carca_tpu.parallel.retrieval import (embed_catalog, queries,
                                              topk_given_queries)

    # sparse: 3000 items, few users → most items unseen
    cat = synthetic_catalog(n_users=60, n_real_items=3000, seed=6)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=10,
                     n_blocks=1, n_heads=2, dropout=0.0, decoder="dot")
    params = carca_init(jax.random.PRNGKey(1), mc)
    attrs = jnp.asarray(cat.attrs)
    counts = np.bincount(np.asarray(cat.items), minlength=cat.n_items)
    seen = np.flatnonzero(counts[1:]) + 1
    assert len(seen) < cat.n_items // 2
    row_ids = jnp.asarray(np.concatenate([[0], seen]), jnp.int32)
    emb = embed_catalog(params, mc, attrs[row_ids], global_ids=row_ids)

    ds = DeviceDataset(cat, 8, 10)
    rows = jnp.asarray(ds.users("test")[:16], jnp.int32)
    from carca_tpu.data.device_pipeline import _profile_slots
    p_evt, valid, *_ = _profile_slots(ds.arrays, "test", rows, 8)
    p_x = jnp.where(valid, ds.arrays["items"][p_evt], 0)
    p_c = ds.arrays["ctx"][p_evt] * valid[..., None]
    q = queries(params, mc, (p_x, None, p_c), attrs)
    _, ids = topk_given_queries(q, emb, mc, 5, exclude=p_x, row_ids=row_ids,
                                use_kernel=False)
    got = set(np.asarray(ids).ravel().tolist())
    assert got <= set(seen.tolist())  # only seen items ever returned


def test_quantized_index_matches_float_ranking(setup):
    """int8 stage-1 index: kernel and XLA paths agree with each other and
    with the dequantized-float oracle; quantization error is within the
    per-row step bound so well-separated ranks are preserved."""
    from carca_tpu.ops.retrieval_topk import (dequantize_index,
                                              quantize_index)
    from carca_tpu.parallel.retrieval import (catalog_in_decoder_space,
                                              queries, topk_given_queries)

    mc, params, profile, attrs = setup
    k = 10
    q = queries(params, mc, profile, attrs)
    # regression: an all-zero query row (batch padding embeds to zero)
    # once wiped whole rows in the packed extraction — a float-domain id
    # payload landed in the denormal range and flush-to-zero erased it
    q = q.at[1].set(0.0)
    e = catalog_in_decoder_space(embed_catalog(params, mc, attrs), mc)
    qi = quantize_index(e)

    # reconstruction error bounded by half a quantization step per element
    err = np.abs(np.asarray(dequantize_index(qi) - e))
    step = np.asarray(qi.scales)[0][:, None]
    assert (err <= 0.5 * step + 1e-7).all()
    assert np.asarray(qi.qvals)[0].max() == 0  # pad row stays zero

    # XLA path scores the exact dequantized floats — brute-force parity
    vx, ix = topk_given_queries(q, qi, mc, k, in_decoder_space=True,
                                use_kernel=False)
    s = np.array(np.asarray(jnp.einsum("bd,rd->br", q, dequantize_index(qi))))
    s[:, 0] = -np.inf
    for b in range(s.shape[0]):
        order = np.argsort(-s[b], kind="stable")[:k]
        np.testing.assert_array_equal(np.asarray(ix[b]), order)
        np.testing.assert_allclose(np.asarray(vx[b]), s[b][order], rtol=1e-5)

    # kernel path casts queries to bf16 (documented precision choice):
    # every returned id must score within bf16 rounding of its exact
    # dequantized dot, and must reach the exact top-k up to that rounding
    vq, iq = topk_given_queries(q, qi, mc, k, in_decoder_space=True,
                                use_kernel=True)
    tol = 0.01 * np.abs(s[np.isfinite(s)]).max() + 1e-4
    for b in range(s.shape[0]):
        np.testing.assert_allclose(np.asarray(vq[b]),
                                   s[b][np.asarray(iq[b])], atol=tol)
        kth = np.sort(s[b])[::-1][k - 1]
        assert (s[b][np.asarray(iq[b])] >= kth - tol).all()

    # vs the float index: scores within the dot-product quantization bound
    vf, _ = topk_given_queries(q, e, mc, k, in_decoder_space=True,
                               use_kernel=False)
    bound = (0.5 * np.abs(np.asarray(q)).sum(axis=1, keepdims=True)
             * float(np.asarray(qi.scales).max()) + tol)
    assert (np.abs(np.asarray(vq) - np.asarray(vf)) <= bound).all()

    with pytest.raises(ValueError, match="decoder-space"):
        topk_given_queries(q, qi, mc, k, in_decoder_space=False)


def test_quantized_recommender_rerank_matches_float():
    """With the CA reranker, an int8 stage-1 shortlist re-scored exactly
    yields the same recommendations as the float index whenever the
    shortlist safely covers the candidates (it does at this scale)."""
    from carca_tpu.serve.recommender import Recommender

    cat = synthetic_catalog(n_users=40, n_real_items=111, seed=11)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=10,
                     n_blocks=1, n_heads=2, dropout=0.0, embedding="all",
                     decoder="ca")
    params = carca_init(jax.random.PRNGKey(2), mc)
    kw = dict(shortlist=64, batch_buckets=(4,))
    rec_f = Recommender(params, mc, np.asarray(cat.attrs), **kw)
    rec_q = Recommender(params, mc, np.asarray(cat.attrs), quantize=True,
                        **kw)
    from carca_tpu.ops.retrieval_topk import QuantizedIndex
    assert isinstance(rec_q.catalog_emb, QuantizedIndex)
    assert rec_q.catalog_emb.qvals.dtype == jnp.int8

    hists = [[3, 9, 4], [17, 2], [1], [30, 8, 21, 5]]
    ids_f, v_f = rec_f.recommend(hists, k=5)
    ids_q, v_q = rec_q.recommend(hists, k=5)
    np.testing.assert_array_equal(ids_f, ids_q)
    np.testing.assert_allclose(v_f, v_q, rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError, match="quantize"):
        Recommender(params, mc, np.asarray(cat.attrs), quantize="yes", **kw)


def test_sharded_serving_index_matches_single_device():
    """A Recommender whose stage-1 index is row-sharded over the model
    axis returns the same recommendations as the single-device one —
    float and int8, full and seen-only indexes."""
    skip_unless_devices(8)
    from carca_tpu.serve.recommender import Recommender

    cat = synthetic_catalog(n_users=48, n_real_items=333, seed=3)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=10,
                     n_blocks=1, n_heads=2, dropout=0.0, embedding="all",
                     decoder="ca")
    params = carca_init(jax.random.PRNGKey(5), mc)
    mesh = make_mesh((2, 4), ("data", "model"))
    hists = [[3, 9, 4], [17, 2], [1], [30, 8, 21, 5]]
    seen = np.unique(np.asarray(cat.items))

    for quantize in (False, True):
        for index_ids in (None, seen):
            kw = dict(shortlist=64, batch_buckets=(4,), quantize=quantize,
                      index_ids=index_ids)
            base = Recommender(params, mc, np.asarray(cat.attrs), **kw)
            shrd = Recommender(params, mc, np.asarray(cat.attrs),
                               mesh=mesh, **kw)
            ids0, v0 = base.recommend(hists, k=5)
            ids1, v1 = shrd.recommend(hists, k=5)
            np.testing.assert_array_equal(ids0, ids1)
            np.testing.assert_allclose(v0, v1, rtol=2e-4, atol=2e-4)
