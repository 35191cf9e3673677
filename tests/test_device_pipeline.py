"""On-device batch assembly vs the host BatchBuilder: deterministic fields
must match exactly; negatives obey the sampler contract (domain + rejection
against everything visible on device)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.data.dataset import BatchBuilder
from carca_tpu.data.device_pipeline import (DeviceDataset, assemble_eval,
                                            assemble_train)
from carca_tpu.data.synthetic import synthetic_catalog


@pytest.fixture(scope="module")
def setup():
    cat = synthetic_catalog(n_users=200, n_real_items=300, seed=5)
    L, T = 10, 15
    host = BatchBuilder(cat, L, T, test=True)
    dev = DeviceDataset(cat, L, T, test=True)
    return cat, L, T, host, dev


def test_users_match(setup):
    _, _, _, host, dev = setup
    for mode in ("train", "val", "test"):
        np.testing.assert_array_equal(host.users(mode), dev.users(mode))


def test_train_assembly_matches_host(setup):
    cat, L, T, host, dev = setup
    rows = np.concatenate([host.users("train")[:30], [-1, -1]])
    ref = host.train_batch(rows, np.random.default_rng(0))
    got = assemble_train(dev.arrays, L, cat.n_items,
                         jnp.asarray(rows, jnp.int32), jax.random.PRNGKey(0))
    for k in ("p_x", "p_c", "y_true"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["o_x"][:, :L]),
                                  ref["o_x"][:, :L])
    np.testing.assert_array_equal(np.asarray(got["o_c"]), ref["o_c"])
    assert int(got["n_valid"]) == int(ref["n_valid"])
    # negatives: placed only in valid slots, in [1, n_items-1], not visible
    negs = np.asarray(got["o_x"][:, L:])
    p_x = np.asarray(got["p_x"])
    pos = np.asarray(got["o_x"][:, :L])
    assert ((negs == 0) == (p_x == 0)).all()
    live = negs[p_x > 0]
    assert live.min() >= 1 and live.max() <= cat.n_items - 1
    for b in range(len(rows)):
        row_negs = set(negs[b][negs[b] > 0].tolist())
        assert not row_negs & set(p_x[b][p_x[b] > 0].tolist())
        assert not row_negs & set(pos[b][pos[b] > 0].tolist())


def test_packed_gather_fallback_matches(setup):
    """The fused evt_packed gather (item ids ride as exact f32 values) must
    agree field-for-field with the separate-gather fallback used beyond
    2²⁴ items. Ids must NOT be bitcast: ids bitcast to f32 are denormals,
    which hardware may flush to zero in a relayout (caught only by an
    accelerator run; this CPU test pins the two paths to each other)."""
    cat, L, T, host, dev = setup
    rows = jnp.asarray(np.concatenate([host.users("train")[:16], [-1]]),
                       jnp.int32)
    nopack = {k: v for k, v in dev.arrays.items() if k != "evt_packed"}
    assert "evt_packed" in dev.arrays
    a = assemble_train(dev.arrays, L, cat.n_items, rows, jax.random.PRNGKey(7))
    b = assemble_train(nopack, L, cat.n_items, rows, jax.random.PRNGKey(7))
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)
    rows_e = jnp.asarray(host.users("test")[:12], jnp.int32)
    a = assemble_eval(dev.arrays, L, T, cat.n_items, "test", rows_e,
                      jax.random.PRNGKey(8))
    b = assemble_eval(nopack, L, T, cat.n_items, "test", rows_e,
                      jax.random.PRNGKey(8))
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["val", "test"])
def test_eval_assembly_matches_host(setup, mode):
    cat, L, T, host, dev = setup
    rows = host.users(mode)[:24]
    ref = host.eval_batch(rows, np.random.default_rng(1), mode)
    got = assemble_eval(dev.arrays, L, T, cat.n_items, mode,
                        jnp.asarray(rows, jnp.int32), jax.random.PRNGKey(1))
    for k in ("p_x", "p_c", "y_true"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(got["o_x"][:, 0]),
                                  ref["o_x"][:, 0])  # held-out positive
    np.testing.assert_array_equal(np.asarray(got["o_c"]), ref["o_c"])
    assert int(got["n_valid"]) == int(ref["n_valid"])


def test_fit_device_pipeline_end_to_end(tmp_path):
    """Two epochs through fit() with the device pipeline on the CPU mesh."""
    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=150, n_real_items=100, seed=2)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="ca")
    cfg = Config(model=mc,
                 data=DataConfig(synthetic=True, device_pipeline=True),
                 train=TrainConfig(batch_size=32, epochs=2, early_stop=5,
                                   out_dir=str(tmp_path), seed=0,
                                   inner_steps=2))  # exercise the scan path
    state, metrics = fit(cfg, cat, log=False)
    assert metrics["epochs_run"] == 2
    assert np.isfinite(metrics["val_loss"])
    assert 0.0 <= metrics["val_hr"] <= 1.0


def test_scanned_eval_matches_per_batch_eval(setup):
    """evaluate_device with the scanned dispatch must produce exactly the
    same (HR, NDCG, loss) as per-batch dispatches — same per-batch keys."""
    from carca_tpu.config import ModelConfig, TrainConfig
    from carca_tpu.models.carca import carca_init
    from carca_tpu.train.loop import (evaluate_device, make_device_eval_step,
                                      make_scanned_device_eval_step)

    cat, L, T, host, dev = setup
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=L, target_len=T, n_blocks=1,
                     n_heads=2, dropout=0.0, decoder="ca")
    params = carca_init(jax.random.PRNGKey(3), mc)
    attrs = jnp.asarray(cat.attrs)
    users = dev.users("val")  # 3 batches of 16 at inner=2 → scan + remainder
    step = make_device_eval_step(mc, 10, "val")
    scanned = make_scanned_device_eval_step(mc, 10, "val", 2)
    key = jax.random.PRNGKey(11)
    ref = evaluate_device(step, params, attrs, dev.arrays, users[:48], 16, key)
    got = evaluate_device(step, params, attrs, dev.arrays, users[:48], 16, key,
                          scanned_step=scanned, inner_steps=2)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_scanned_step_matches_single_steps(setup):
    """K steps through the lax.scan dispatch ≡ K single-step dispatches —
    identical RNG threading, identical final params and per-step losses."""
    from carca_tpu.config import ModelConfig, TrainConfig
    from carca_tpu.train.loop import (make_device_train_step,
                                      make_scanned_device_train_step)
    from carca_tpu.train.state import create_train_state, make_optimizer

    cat, L, T, host, dev = setup
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=L, target_len=T, n_blocks=1,
                     n_heads=2, dropout=0.0, decoder="ca")
    tc = TrainConfig(batch_size=16, seed=0)
    tx = make_optimizer(tc)
    attrs = jnp.asarray(cat.attrs)
    users = dev.users("train")
    K = 3
    chunks = np.stack([np.resize(users[i * 16:(i + 1) * 16], 16)
                       for i in range(K)])

    s1 = create_train_state(jax.random.PRNGKey(7), mc, tc, tx)
    single = make_device_train_step(mc, tx)
    losses_seq = []
    for i in range(K):
        s1, loss = single(s1, attrs, dev.arrays,
                          jnp.asarray(chunks[i], jnp.int32))
        losses_seq.append(float(loss))

    s2 = create_train_state(jax.random.PRNGKey(7), mc, tc, tx)
    scanned = make_scanned_device_train_step(mc, tx, K)
    s2, losses = scanned(s2, attrs, dev.arrays, jnp.asarray(chunks, jnp.int32))

    np.testing.assert_allclose(np.asarray(losses), losses_seq, rtol=1e-5)
    assert int(s2.step) == int(s1.step) == K
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                rtol=2e-5, atol=1e-6),
        s1.params, s2.params)


def test_device_generated_catalog():
    """synthetic_catalog_device: same Catalog contract as the host
    generator (pad row, id domain, CSR alignment) with the big arrays
    already on device; composes with DeviceDataset + assembly."""
    from carca_tpu.data.synthetic import synthetic_catalog_device

    cat = synthetic_catalog_device(n_users=150, n_real_items=300, n_attrs=6,
                                   n_ctx=3, seed=7)
    assert cat.n_items == 301 and cat.n_attrs == 6 and cat.n_ctx == 3
    assert isinstance(cat.attrs, jnp.ndarray)
    items = np.asarray(cat.items)
    assert items.min() >= 1 and items.max() <= 300
    assert int(cat.offsets[-1]) == items.shape[0] == np.asarray(cat.ctx_vals).shape[0]
    np.testing.assert_array_equal(np.asarray(cat.attrs[0]), 0.0)
    # zipf-ish: low ids (popular ranks) occur more often than high ids
    assert (items <= 30).sum() > (items > 270).sum()

    ds = DeviceDataset(cat, seq_len=8, target_len=12, test=True)
    users = ds.users("train")[:16]
    b = assemble_train(ds.arrays, 8, cat.n_items, jnp.asarray(users, jnp.int32),
                       jax.random.PRNGKey(0))
    o = np.asarray(b["o_x"])
    assert np.isfinite(np.asarray(b["o_c"])).all()
    assert (o >= 0).all() and (o < cat.n_items).all()
    assert np.asarray(b["y_true"]).max() == 1.0


def test_exact_rejection_avoids_full_history():
    """reject_width = hist_max → negatives never collide with ANY item in
    the user's history (the reference's sampler contract,
    src/data.py:77-87), including items outside the visible window."""
    from carca_tpu.data.loaders import Catalog

    # one user, 24-item history over a 30-item catalog, window L=4 —
    # most of the history is OUTSIDE the window
    hist = np.asarray([1 + (i % 24) for i in range(24)], np.int32)
    cat = Catalog(
        attrs=np.zeros((31, 4), np.float32),
        user_ids=np.arange(1, dtype=np.int64),
        items=hist,
        offsets=np.asarray([0, 24], np.int64),
        ctx_vals=np.zeros((24, 2), np.float32),
    )
    ds = DeviceDataset(cat, seq_len=4, target_len=5, test=True)
    assert ds.hist_max == 24
    rows = jnp.asarray([0], jnp.int32)
    forbidden = set(hist.tolist())

    hit_window_only = False
    for seed in range(40):
        b_exact = assemble_train(ds.arrays, 4, cat.n_items, rows,
                                 jax.random.PRNGKey(seed), reject_width=24)
        negs = np.asarray(b_exact["o_x"])[0, 4:]
        assert not (set(negs[negs > 0].tolist()) & forbidden)

        e_exact = assemble_eval(ds.arrays, 4, 5, cat.n_items, "val", rows,
                                jax.random.PRNGKey(seed), reject_width=24)
        enegs = np.asarray(e_exact["o_x"])[0, 1:]
        assert not (set(enegs[enegs > 0].tolist()) & forbidden)

        # sanity: the windowed approximation DOES hit old history items
        b_win = assemble_train(ds.arrays, 4, cat.n_items, rows,
                               jax.random.PRNGKey(seed))
        wnegs = np.asarray(b_win["o_x"])[0, 4:]
        hit_window_only |= bool(set(wnegs[wnegs > 0].tolist()) & forbidden)
    assert hit_window_only  # the approximation is observably weaker


def test_popularity_negative_sampling():
    """neg_pop draws from the empirical unigram distribution (a uniform
    random event's item id): frequent items appear as negatives far more
    often than rare ones, the reject set is still honored, and eval
    negatives remain uniform (reference protocol)."""
    cat = synthetic_catalog(n_users=400, n_real_items=5000, seed=9)
    ds = DeviceDataset(cat, seq_len=8, target_len=10, test=True)
    rows = jnp.asarray(ds.users("train")[:64], jnp.int32)

    counts = np.zeros(cat.n_items, np.int64)
    for seed in range(30):
        b = assemble_train(ds.arrays, 8, cat.n_items, rows,
                           jax.random.PRNGKey(seed), reject_width=ds.hist_max,
                           neg_pop=True)
        o = np.asarray(b["o_x"])[:, 8:]
        np.add.at(counts, o[o > 0], 1)
        # rejection still holds per row
        hist = np.asarray(cat.items[cat.offsets[int(rows[0])]:
                                    cat.offsets[int(rows[0]) + 1]])
        assert not (set(o[0][o[0] > 0].tolist()) & set(hist.tolist()))

    ev_counts = np.bincount(np.asarray(cat.items), minlength=cat.n_items)
    popular = np.argsort(-ev_counts)[:50]
    rare = np.where(ev_counts == 0)[0]
    # items with zero events can never be drawn; popular ones dominate
    assert counts[rare].sum() == 0
    assert counts[popular].sum() > 0.3 * counts.sum()


def test_verbose2_per_batch_logging(tmp_path, capsys):
    """tc.verbose == 2 prints a running-mean train loss per batch
    (the reference's verbose=2 behavior, src/train.py:99-101) — on the
    scanned dispatch path each inner step still yields one line."""
    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=100, n_real_items=80, seed=3)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="ca")
    cfg = Config(model=mc,
                 data=DataConfig(synthetic=True, device_pipeline=True),
                 train=TrainConfig(batch_size=32, epochs=1, verbose=2,
                                   out_dir=str(tmp_path), checkpoint=False,
                                   inner_steps=2))
    fit(cfg, cat)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "Batch" in ln and "Train Loss" in ln]
    # 100 users -> some full + remainder batches; every train batch logs
    import math
    from carca_tpu.data.device_pipeline import DeviceDataset
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, test=True)
    expect = math.ceil(len(dd.users("train")) / 32)
    assert len(lines) == expect
    assert lines[0].startswith("Epoch 001 Batch 0001")
    # running means are finite numbers
    assert all(float(ln.rsplit("=", 1)[1]) > 0 for ln in lines)


def test_window_rejection_note_surfaced(tmp_path, capsys):
    """exact_rejection=False on the device pipeline prints the protocol-
    deviation note (eval negatives reject only against the visible
    window; the reference rejects against the full history,
    src/data.py:77-87)."""
    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=100, n_real_items=80, seed=3)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="ca")
    cfg = Config(model=mc,
                 data=DataConfig(synthetic=True, device_pipeline=True,
                                 exact_rejection=False),
                 train=TrainConfig(batch_size=32, epochs=1,
                                   out_dir=str(tmp_path), checkpoint=False))
    fit(cfg, cat)
    out = capsys.readouterr().out
    assert "negative rejection uses the visible window only" in out
