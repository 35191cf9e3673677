"""Serving layer: the two-stage recommender must agree with brute-force
scoring through the public model API (``carca_apply``), exclude history,
survive batch-bucket padding, and restore from a real checkpoint."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.config import Config, ModelConfig, TrainConfig
from carca_tpu.data.synthetic import synthetic_catalog
from carca_tpu.models.carca import carca_apply, carca_init
from carca_tpu.serve.recommender import (Recommender, config_from_run_dir,
                                         load_recommender, pad_histories)

N_ITEMS = 97


def make_model(decoder: str, cat, **kw) -> ModelConfig:
    return ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                       n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=10,
                       n_blocks=2, n_heads=2, dropout=0.0, embedding="all",
                       decoder=decoder, **kw)


@pytest.fixture(scope="module")
def cat():
    return synthetic_catalog(n_users=40, n_real_items=N_ITEMS - 1, seed=3)


def histories_of(cat, users):
    out = []
    for u in users:
        lo, hi = int(cat.offsets[u]), int(cat.offsets[u + 1])
        out.append(cat.items[lo:hi].tolist())
    return out


def bruteforce_scores(params, mc, p_x, p_c, attrs):
    """[B, n_items] decoder eval scores of every catalog item under zero
    request ctx, via the public forward."""
    b = p_x.shape[0]
    all_ids = jnp.broadcast_to(jnp.arange(mc.n_items, dtype=jnp.int32)[None],
                               (b, mc.n_items))
    o_c = jnp.zeros((b, mc.n_items, mc.n_ctx), jnp.float32)
    return np.array(carca_apply(
        params, mc, (jnp.asarray(p_x), None, jnp.asarray(p_c)),
        [(all_ids, None, o_c)], train=False, attrs_table=attrs))


def test_pad_histories_right_aligned():
    p_x, p_c = pad_histories([[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9]],
                             seq_len=4, n_ctx=2)
    np.testing.assert_array_equal(p_x[0], [0, 5, 6, 7])
    np.testing.assert_array_equal(p_x[1], [6, 7, 8, 9])  # last seq_len kept
    assert p_c.shape == (2, 4, 2) and (p_c == 0).all()
    ctxs = [np.ones((3, 2)), np.full((9, 2), 2.0)]
    _, p_c = pad_histories([[5, 6, 7], list(range(1, 10))], 4, ctxs, 2)
    assert (p_c[0, 1:] == 1.0).all() and (p_c[0, 0] == 0).all()
    assert (p_c[1] == 2.0).all()


@pytest.mark.parametrize("decoder,l2", [("dot", False), ("wdot", True),
                                        ("ca", False)])
def test_recommend_matches_bruteforce(cat, decoder, l2):
    mc = make_model(decoder, cat, l2_norm=l2)
    params = carca_init(jax.random.PRNGKey(1), mc)
    users = list(range(6))
    hists = histories_of(cat, users)
    # ca reranks the full catalog when shortlist >= n_items → exact
    rec = Recommender(params, mc, cat.attrs, shortlist=mc.n_items,
                      batch_buckets=(8,))
    k = 7
    ids, scores = rec.recommend(hists, k=k)
    assert ids.shape == (6, k)

    p_x, p_c = pad_histories(hists, mc.seq_len, None, mc.n_ctx)
    s = bruteforce_scores(params, mc, p_x, p_c, jnp.asarray(cat.attrs))
    s[:, 0] = -np.inf
    for b, hist in enumerate(hists):
        s[b, p_x[b][p_x[b] > 0]] = -np.inf  # visible-window exclusion
        order = np.argsort(-s[b], kind="stable")[:k]
        np.testing.assert_array_equal(ids[b], order)
        np.testing.assert_allclose(scores[b], s[b][order],
                                   rtol=2e-5, atol=2e-5)
        assert not np.isin(ids[b], p_x[b][p_x[b] > 0]).any()


def test_recommend_batch_padding_and_score_candidates(cat):
    mc = make_model("ca", cat)
    params = carca_init(jax.random.PRNGKey(2), mc)
    rec = Recommender(params, mc, cat.attrs, shortlist=32,
                      batch_buckets=(1, 8))
    hists = histories_of(cat, [0, 1, 2])  # pads 3 → bucket 8
    ids, scores = rec.recommend(hists, k=5)
    assert ids.shape == (3, 5)
    # returned scores must equal the direct ranking API on the same ids
    y = rec.score_candidates(hists, ids)
    np.testing.assert_allclose(scores, y, rtol=2e-5, atol=2e-5)
    # single-row request rides the size-1 bucket
    ids1, _ = rec.recommend(hists[:1], k=5)
    np.testing.assert_array_equal(ids1[0], ids[0])


def test_checkpoint_roundtrip_serving(cat, tmp_path):
    from carca_tpu.train.checkpoint import CheckpointKeeper
    from carca_tpu.train.state import create_train_state, make_optimizer

    mc = make_model("dot", cat)
    tc = TrainConfig(batch_size=8, out_dir=str(tmp_path))
    cfg = Config(model=mc, train=tc)
    cfg.dump_args_json(os.path.join(tmp_path, "args.json"))

    tx = make_optimizer(tc)
    state = create_train_state(jax.random.PRNGKey(7), mc, tc, tx)
    keeper = CheckpointKeeper(os.path.join(tmp_path, "ckpt"))
    keeper.save(0, state, {"ndcg": 0.5, "hr": 0.6})
    keeper.close()

    got = config_from_run_dir(str(tmp_path))
    assert got.model == mc and got.train.batch_size == 8

    rec = load_recommender(str(tmp_path), cat.attrs, batch_buckets=(8,))
    hists = histories_of(cat, range(4))
    ids, scores = rec.recommend(hists, k=5)

    direct = Recommender(state.params, mc, cat.attrs, batch_buckets=(8,))
    ids2, scores2 = direct.recommend(hists, k=5)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_allclose(scores, scores2, rtol=1e-6)


def test_config_from_old_run_dir_ignores_use_pallas(cat, tmp_path):
    """args.json files written before the fused-attention kernel was
    retired still carry ``use_pallas``; they load without it."""
    mc = make_model("ca", cat)
    cfg = Config(model=mc, train=TrainConfig(batch_size=8))
    path = os.path.join(tmp_path, "args.json")
    cfg.dump_args_json(path)
    flat = json.load(open(path))
    flat["use_pallas"] = "auto"
    with open(path, "w") as fh:
        json.dump(flat, fh)
    got = config_from_run_dir(str(tmp_path))
    assert got.model == mc and not hasattr(got.model, "use_pallas")


def test_recommender_plain_stage1_matches_kernel(cat):
    """``use_kernel=False`` (the plain XLA stage 1 used as the check's
    reference) and the kernel serve the same ids."""
    params = carca_init(jax.random.PRNGKey(4), make_model("ca", cat))
    mc = make_model("ca", cat)
    hists = histories_of(cat, range(5))
    a = Recommender(params, mc, cat.attrs, shortlist=20, batch_buckets=(8,))
    b = Recommender(params, mc, cat.attrs, shortlist=20, batch_buckets=(8,),
                    use_kernel=False)
    ids_a, v_a = a.recommend(hists, k=5)
    ids_b, v_b = b.recommend(hists, k=5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(v_a, v_b, rtol=1e-6)


def test_service_request_shapes(cat, tmp_path, monkeypatch, capsys):
    """The JSON-lines loop answers well-formed and malformed requests."""
    import io

    from carca_tpu.serve import service
    from carca_tpu.train.checkpoint import CheckpointKeeper
    from carca_tpu.train.state import create_train_state, make_optimizer

    from carca_tpu.config import DataConfig

    mc = make_model("dot", cat)
    tc = TrainConfig(batch_size=8, out_dir=str(tmp_path))
    dc = DataConfig(synthetic=True, synthetic_users=40, synthetic_items=96,
                    synthetic_seed=3)  # regenerates the fixture catalog
    Config(model=mc, data=dc, train=tc,
           ).dump_args_json(os.path.join(tmp_path, "args.json"))
    tx = make_optimizer(tc)
    state = create_train_state(jax.random.PRNGKey(7), mc, tc, tx)
    keeper = CheckpointKeeper(os.path.join(tmp_path, "ckpt"))
    keeper.save(0, state, {"ndcg": 0.5, "hr": 0.6})
    keeper.close()

    reqs = "\n".join([
        json.dumps({"history": [3, 4, 5], "k": 4, "id": "a"}),
        json.dumps({"user": 1, "id": "b"}),
        "{not json",
    ])
    monkeypatch.setattr(service.sys, "stdin", io.StringIO(reqs))
    # catalog is synthetic-regenerated: give the service the same data cfg
    service.main(["--run_dir", str(tmp_path), "--k", "3"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    assert len(lines[0]["items"]) == 4 and lines[0]["id"] == "a"
    assert len(lines[1]["items"]) == 3 and lines[1]["id"] == "b"
    assert "error" in lines[2]


def test_small_catalog_pad_slots_and_k_validation(cat):
    """Requests near the catalog size: pad/excluded slots come back -inf
    (not sigmoid(-inf)=0), oversized k raises, and the service loop never
    emits non-JSON -Infinity."""
    mc = make_model("dot", cat)
    params = carca_init(jax.random.PRNGKey(3), mc)
    rec = Recommender(params, mc, cat.attrs, batch_buckets=(1,))
    hist = histories_of(cat, [0])[0]
    k = N_ITEMS - 2  # > n_valid_items - |history| - pad → -inf tail
    ids, scores = rec.recommend([hist], k=k)
    assert not np.isfinite(scores[0][-1])
    finite = np.isfinite(scores[0])
    window = np.asarray(hist[-mc.seq_len:])  # visible-window exclusion
    assert not np.isin(ids[0][finite], window).any()
    with pytest.raises(ValueError, match="exceeds the stage-1 index"):
        rec.recommend([hist], k=N_ITEMS + 5)


def test_seen_index_recommender_matches_full_on_seen_items():
    """A Recommender with index_ids returns only indexed items, and where
    the full-index result is itself a seen item the two agree (dot decoder:
    stage 1 IS the decoder, so scores are directly comparable)."""
    cat = synthetic_catalog(n_users=150, n_real_items=N_ITEMS - 1, seed=11)
    mc = make_model("dot", cat)
    params = carca_init(jax.random.PRNGKey(4), mc)
    seen = np.unique(np.asarray(cat.items))
    full = Recommender(params, mc, cat.attrs, batch_buckets=(4,))
    sub = Recommender(params, mc, cat.attrs, batch_buckets=(4,),
                      index_ids=seen)
    hists = histories_of(cat, [0, 1, 2, 3])
    ids_f, v_f = full.recommend(hists, k=5)
    ids_s, v_s = sub.recommend(hists, k=5)
    seen_set = set(seen.tolist())
    for r in range(4):
        fin = np.isfinite(v_s[r])
        assert set(ids_s[r][fin].tolist()) <= seen_set
        # rows where the full top-5 is entirely seen must match exactly
        if set(ids_f[r].tolist()) <= seen_set and np.isfinite(v_f[r]).all():
            np.testing.assert_array_equal(ids_s[r], ids_f[r])
            np.testing.assert_allclose(v_s[r], v_f[r], rtol=1e-5)
