"""Checkpoint/resume: full-state roundtrip, best-NDCG retention policy, and
mid-run resume through fit() (the reference cannot resume at all —
SURVEY.md §5)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from carca_tpu.data.synthetic import synthetic_catalog
from carca_tpu.train.checkpoint import CheckpointKeeper
from carca_tpu.train.loop import fit
from carca_tpu.train.state import create_train_state, make_optimizer


def _cfg(out_dir, epochs=2, schedule="none"):
    cat = synthetic_catalog(n_users=120, n_real_items=80, seed=1)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
                     d=16, g=32, seq_len=6, target_len=8, n_blocks=1,
                     n_heads=2, dropout=0.1, decoder="ca")
    tc = TrainConfig(batch_size=32, epochs=epochs, early_stop=50, seed=0,
                     out_dir=out_dir, lr_schedule=schedule,
                     lr_decay_steps=100 if schedule != "none" else 0)
    return cat, Config(model=mc, data=DataConfig(synthetic=True), train=tc)


def test_state_roundtrip_and_best_retention(tmp_path):
    cat, cfg = _cfg(str(tmp_path / "run"))
    tx = make_optimizer(cfg.train)
    state = create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train, tx)

    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    keeper.save(1, state, {"ndcg": 0.5, "hr": 0.6, "epoch": 1})
    keeper.save(2, state, {"ndcg": 0.3, "hr": 0.4, "epoch": 2})  # worse
    assert keeper.best_metrics()["ndcg"] == 0.5  # retention = best NDCG

    # human-browsable sidecar (the reference's filename contract,
    # src/train.py:124, relocated): best/metrics.json mirrors the LAST
    # improving save's metrics
    import json
    side = json.load(open(str(tmp_path / "ckpt" / "best" / "metrics.json")))
    assert side == {"ndcg": 0.5, "hr": 0.6, "epoch": 1}  # not the worse save

    restored = keeper.restore_best(state)
    assert restored is not None and restored[0] == 1
    for a, b in zip(jax.tree_util.tree_leaves(restored[1].params),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # optimizer moments + PRNG + step restored too (full-state, not just params)
    for a, b in zip(jax.tree_util.tree_leaves(restored[1].opt_state),
                    jax.tree_util.tree_leaves(state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    keeper.close()


def test_retention_keys_on_select_when_curves_diverge(tmp_path):
    """Round-3 confirmed bug: checkpoint retention was hardwired to
    ``metrics["ndcg"]``, so under ``select_by=retrieval_*`` a
    retrieval-improving save with LOWER sampled NDCG was garbage-collected
    and ``restore_best``/``best_metrics`` returned the NDCG-best epoch —
    precisely the divergent-curves regime the flag exists for (config.py
    select_by rationale). Retention and the metrics.json sidecar must key
    on the saved comparison metric (``select`` when present)."""
    import dataclasses
    import json

    @dataclasses.dataclass
    class _State:
        params: dict

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    def _params(v):
        return {"w": np.full((2, 2), v, np.float32)}

    keeper = CheckpointKeeper(str(tmp_path / "div"), select_by="retrieval_hr")
    try:
        # ndcg falls .9 → .5 while the selection metric rises .1 → .2:
        # fit() saved both because ITS comparison (select) improved.
        keeper.save(1, _State(_params(1.0)),
                    {"ndcg": 0.9, "hr": 0.9, "epoch": 1,
                     "select": 0.1, "select_by": "retrieval_hr"})
        keeper.save(2, _State(_params(2.0)),
                    {"ndcg": 0.5, "hr": 0.5, "epoch": 2,
                     "select": 0.2, "select_by": "retrieval_hr"})
        m = keeper.best_metrics()
        assert m["epoch"] == 2 and m["select"] == 0.2
        step, restored = keeper.restore_best(_State(_params(0.0)))
        assert step == 2
        np.testing.assert_array_equal(np.asarray(restored.params["w"]),
                                      np.full((2, 2), 2.0, np.float32))
        side = json.load(
            open(str(tmp_path / "div" / "best" / "metrics.json")))
        assert side["epoch"] == 2 and side["select"] == 0.2
    finally:
        keeper.close()

    # plain-ndcg runs (no "select" key) keep the reference retention rule
    keeper = CheckpointKeeper(str(tmp_path / "ndcg"))
    try:
        keeper.save(1, _State(_params(1.0)), {"ndcg": 0.9, "hr": 0.9,
                                              "epoch": 1})
        keeper.save(2, _State(_params(2.0)), {"ndcg": 0.5, "hr": 0.5,
                                              "epoch": 2})
        assert keeper.best_metrics()["epoch"] == 1
    finally:
        keeper.close()

    # regime change across a resume (advisor, round 4): a checkpoint
    # retained under a DIFFERENT select_by must not win the comparison on
    # its incommensurable stale metric — it scores 0.0, mirroring
    # loop.py::selection_value, so the new regime's first save replaces it
    keeper = CheckpointKeeper(str(tmp_path / "regime"),
                              select_by="retrieval_ndcg")
    try:
        # old run retained this under select_by=retrieval_hr with a high
        # stale 'select'; new regime's save has a lower raw number
        keeper.save(1, _State(_params(1.0)),
                    {"ndcg": 0.9, "hr": 0.9, "epoch": 1,
                     "select": 0.9, "select_by": "retrieval_hr"})
        keeper.save(2, _State(_params(2.0)),
                    {"ndcg": 0.5, "hr": 0.5, "epoch": 2,
                     "select": 0.05, "select_by": "retrieval_ndcg"})
        m = keeper.best_metrics()
        assert m["epoch"] == 2 and m["select_by"] == "retrieval_ndcg"
    finally:
        keeper.close()


def test_fit_resumes_mid_run(tmp_path):
    out = str(tmp_path / "resume_run")
    cat, cfg2 = _cfg(out, epochs=2)
    state2, m2 = fit(cfg2, cat, log=False)

    # same out_dir, more epochs → resumes from the saved epoch-2 state
    cat, cfg3 = _cfg(out, epochs=3)
    state3, m3 = fit(cfg3, cat, log=False)
    assert m3["epochs_run"] == 3
    assert int(state3.step) > int(state2.step)


def test_lr_schedules_smoke():
    cat, cfg = _cfg("/tmp/unused", schedule="cosine")
    tx = make_optimizer(cfg.train)
    state = create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train, tx)
    g = jax.tree_util.tree_map(jnp.ones_like, state.params)
    up, _ = tx.update(g, state.opt_state, state.params)
    assert all(np.isfinite(np.asarray(l)).all()
               for l in jax.tree_util.tree_leaves(up))


def test_trainstate_is_a_pytree_without_flax():
    """TrainState flattens to its four fields (key paths .params, ...,
    .step) and ``replace`` returns a new state, inside and outside jit."""
    from carca_tpu.train.state import TrainState

    st = TrainState(params={"w": jnp.ones(3)}, opt_state=(jnp.zeros(2),),
                    rng=jnp.zeros(2, jnp.uint32), step=jnp.zeros((), jnp.int32))
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(st)[0]]
    assert paths == [".params['w']", ".opt_state[0]", ".rng", ".step"]
    st2 = st.replace(step=st.step + 1)
    assert int(st2.step) == 1 and int(st.step) == 0  # frozen: a copy
    st3 = jax.jit(lambda s: s.replace(step=s.step + 2))(st)
    assert isinstance(st3, TrainState) and int(st3.step) == 2
    import dataclasses
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.step = 5


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_with_sparse_adam_state(tmp_path):
    """Full state with the split dense/sparse (lazy row-Adam) optimizer
    state and a bf16 leaf survives latest/ + ema/ save and restore."""
    cat, cfg = _cfg(str(tmp_path / "run"))
    tx = make_optimizer(cfg.train)
    state = create_train_state(jax.random.PRNGKey(3), cfg.model, cfg.train,
                               tx, sparse_items=True)
    assert set(state.opt_state) == {"dense", "items"}
    state = state.replace(step=jnp.asarray(7, jnp.int32))
    ema = jax.tree_util.tree_map(lambda x: (x * 0.5).astype(jnp.bfloat16),
                                 state.params)
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    keeper.save_latest(4, state, ema=ema)
    template = create_train_state(jax.random.PRNGKey(9), cfg.model,
                                  cfg.train, tx, sparse_items=True)
    step, got = keeper.restore_latest(template)
    assert step == 4 and int(got.step) == 7
    _leaves_equal(got, state)
    _leaves_equal(keeper.restore_latest_ema(ema), ema)
    # a dense-Adam template is a different tree: ValueError (fit() then
    # retries with the other structure)
    dense = create_train_state(jax.random.PRNGKey(9), cfg.model, cfg.train,
                               tx, sparse_items=False)
    with pytest.raises(ValueError, match="does not match"):
        keeper.restore_latest(dense)
    keeper.close()


def test_async_saves_are_atomic_and_keep_one(tmp_path):
    """save_latest returns after the device→host copy; back-to-back saves
    wait for each other, only the newest step directory survives, and a
    leftover temporary directory is never mistaken for a checkpoint."""
    cat, cfg = _cfg(str(tmp_path / "run"))
    tx = make_optimizer(cfg.train)
    state = create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train, tx)
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    latest = tmp_path / "ckpt" / "latest"
    (latest / ".tmp-99").mkdir(parents=True)  # a crashed writer's leftover
    for epoch in range(1, 4):
        keeper.save_latest(epoch, state.replace(
            step=jnp.asarray(epoch, jnp.int32)))
    step, got = keeper.restore_latest(state)  # waits for the last write
    assert step == 3 and int(got.step) == 3
    assert sorted(p.name for p in latest.iterdir()
                  if p.name.isdigit()) == ["3"]
    assert (latest / "3" / "manifest.json").exists()
    keeper.close()
    # a fresh keeper (a restarted process) sees the same checkpoint
    again = CheckpointKeeper(str(tmp_path / "ckpt"))
    assert again.restore_latest(state)[0] == 3
    again.close()


def test_restore_onto_an_8_device_mesh(tmp_path):
    """A checkpoint written from one device restores into a template
    sharded over an 8-virtual-device mesh: every leaf takes the
    template's sharding (resume onto another mesh)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from carca_tpu.parallel.mesh import make_mesh, param_shardings
    from tests.conftest import skip_unless_devices

    skip_unless_devices(8)
    cat, cfg = _cfg(str(tmp_path / "run"))
    tx = make_optimizer(cfg.train)
    state = create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train, tx)
    keeper = CheckpointKeeper(str(tmp_path / "ckpt"))
    keeper.save_latest(1, state)
    mesh = make_mesh((8,), ("data",))
    template = jax.device_put(state, param_shardings(state, mesh))
    step, got = keeper.restore_latest(template)
    _leaves_equal(got, state)
    for leaf in jax.tree_util.tree_leaves(got):
        assert leaf.sharding == NamedSharding(mesh, P())
        assert len(leaf.sharding.device_set) == 8
    keeper.close()
