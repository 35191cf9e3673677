"""Retrieval-aligned training objective: sampled softmax + K negatives.

No reference counterpart (its loss is hard-wired 1-vs-1 masked BCE,
``src/train.py:86-93``); these are additions for the
full-catalog retrieval north star (BASELINE configs[4], DESIGN §11c).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu.data.synthetic import synthetic_catalog
from carca_tpu.models.losses import sampled_softmax


def _np_sampled_softmax(logits, o_x, g, logq=None):
    b = logits.shape[0]
    z = logits.reshape(b, g, -1).astype(np.float64)
    ids = o_x.reshape(b, g, -1)
    if logq is not None:
        z = z - np.where(np.arange(g)[None, :, None] > 0, logq[ids], 0.0)
    tot, n = 0.0, 0
    for i in range(b):
        for t in range(z.shape[2]):
            if ids[i, 0, t] <= 0:
                continue
            col = z[i, :, t]
            tot += -(col[0] - np.log(np.exp(col - col.max()).sum())
                     - col.max())
            n += 1
    return tot / max(n, 1)


def test_sampled_softmax_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    b, g, L = 5, 4, 7
    logits = rng.normal(size=(b, g * L)).astype(np.float32) * 3
    o_x = rng.integers(1, 50, size=(b, g * L)).astype(np.int32)
    o_x[0, :L] = 0  # fully padded row
    o_x[1, 2:L] = 0  # partially padded positives
    got = float(sampled_softmax(jnp.asarray(logits), jnp.asarray(o_x), g))
    want = _np_sampled_softmax(logits, o_x, g)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sampled_softmax_logq_correction():
    rng = np.random.default_rng(1)
    b, g, L, n_items = 4, 3, 5, 30
    logits = rng.normal(size=(b, g * L)).astype(np.float32)
    o_x = rng.integers(1, n_items, size=(b, g * L)).astype(np.int32)
    logq = np.log(rng.uniform(0.01, 1.0, size=n_items)).astype(np.float32)
    got = float(sampled_softmax(jnp.asarray(logits), jnp.asarray(o_x), g,
                                logq=jnp.asarray(logq)))
    want = _np_sampled_softmax(logits, o_x, g, logq=logq)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the positive's logit is NOT corrected: correcting group 0 too would
    # change the loss — verify the two differ on this input
    z = logits.reshape(b, g, L) - logq[o_x.reshape(b, g, L)]
    wrong = _np_sampled_softmax(z.reshape(b, g * L), o_x, g)
    assert abs(got - wrong) > 1e-4


def test_sampled_softmax_all_padded_is_zero_not_nan():
    z = jnp.ones((2, 6))
    o_x = jnp.zeros((2, 6), jnp.int32)
    assert float(sampled_softmax(z, o_x, 3)) == 0.0


def test_assemble_train_k_negatives():
    from carca_tpu.data.device_pipeline import DeviceDataset, assemble_train

    cat = synthetic_catalog(n_users=60, n_real_items=500, seed=2)
    L, K = 8, 3
    dd = DeviceDataset(cat, L, 12, test=True)
    rows = jnp.asarray(dd.users("train")[:16], jnp.int32)
    b = assemble_train(dd.arrays, L, cat.n_items, rows,
                       jax.random.PRNGKey(0), n_neg=K)
    B = 16
    assert b["o_x"].shape == (B, (1 + K) * L)
    assert b["o_c"].shape == (B, (1 + K) * L, cat.n_ctx)
    assert b["y_true"].shape == (B, (1 + K) * L)
    o_x = np.asarray(b["o_x"])
    p_x = np.asarray(b["p_x"])
    y = np.asarray(b["y_true"])
    # group 0 = positives (labels mirror their validity); groups 1..K all 0
    valid = o_x[:, :L] > 0
    np.testing.assert_array_equal(y[:, :L], valid.astype(np.float32))
    assert (y[:, L:] == 0).all()
    oc = np.asarray(b["o_c"]).reshape(B, 1 + K, L, -1)
    for gidx in range(1, 1 + K):
        # negatives inherit the positives' contexts (src/data.py:130)
        np.testing.assert_array_equal(oc[:, gidx], oc[:, 0])
    negs = o_x[:, L:].reshape(B, K, L)
    for i in range(B):
        real = negs[i][negs[i] > 0]
        # distinct across ALL K groups (joint WOR draw)...
        assert len(np.unique(real)) == len(real)
        # ...and never colliding with the visible window
        window = set(p_x[i][p_x[i] > 0]) | set(o_x[i, :L][o_x[i, :L] > 0])
        assert not (set(real.tolist()) & window)
        # negatives present exactly at valid positions, per group
        np.testing.assert_array_equal(negs[i] > 0,
                                      np.tile(valid[i], (K, 1)))


@pytest.mark.parametrize("loss", ["softmax", "bce"])
def test_fit_k_negatives_end_to_end(tmp_path, loss):
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=150, n_real_items=100, seed=3)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=6, target_len=8,
                     n_blocks=1, n_heads=2, dropout=0.1, decoder="dot")
    cfg = Config(model=mc,
                 data=DataConfig(synthetic=True, device_pipeline=True),
                 train=TrainConfig(batch_size=32, epochs=2, early_stop=5,
                                   out_dir=str(tmp_path / loss),
                                   checkpoint=False, inner_steps=2,
                                   loss=loss, n_train_negatives=4))
    _, m = fit(cfg, cat, log=False)
    assert m["epochs_run"] == 2
    assert np.isfinite(m["val_loss"]) and np.isfinite(m["test_ndcg"])
    assert 0.0 <= m["val_hr"] <= 1.0


def test_k_negatives_requires_device_pipeline(tmp_path):
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(n_users=40, n_real_items=50, seed=1)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=6, target_len=8,
                     n_blocks=1, n_heads=2, decoder="dot")
    cfg = Config(model=mc, data=DataConfig(synthetic=True),
                 train=TrainConfig(batch_size=16, epochs=1,
                                   out_dir=str(tmp_path),
                                   n_train_negatives=2))
    with pytest.raises(ValueError, match="device_pipeline"):
        fit(cfg, cat, log=False)


def test_softmax_loss_gradients_flow():
    """d(loss)/d(params) is finite and nonzero through return_logits."""
    from carca_tpu.models.carca import carca_init
    from carca_tpu.train.loop import train_loss

    cat = synthetic_catalog(n_users=40, n_real_items=60, seed=4)
    L, K = 6, 2
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=L, target_len=8,
                     n_blocks=1, n_heads=2, dropout=0.0, decoder="dot")
    from carca_tpu.data.device_pipeline import DeviceDataset, assemble_train
    dd = DeviceDataset(cat, L, 8, test=True)
    rows = jnp.asarray(dd.users("train")[:8], jnp.int32)
    batch = assemble_train(dd.arrays, L, cat.n_items, rows,
                           jax.random.PRNGKey(1), n_neg=K)
    params = carca_init(jax.random.PRNGKey(0), mc)
    attrs = jnp.asarray(cat.attrs)

    def f(p):
        return train_loss(mc, p, batch, jax.random.PRNGKey(2), attrs,
                          loss_kind="softmax")

    loss, grads = jax.value_and_grad(f)(params)
    assert np.isfinite(float(loss)) and float(loss) > 0
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    assert any(float(jnp.abs(g).max()) > 0 for g in leaves)
