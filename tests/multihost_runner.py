"""Subprocess body for the 2-process multi-host test (test_multihost.py).

Runs a real ``jax.distributed`` program: 2 CPU processes, 1 local device
each, one global 2-device mesh, end-to-end ``fit()`` sharded over it.
This is the pod execution model (SURVEY.md §2.3 multi-host row) exercised
with actual process boundaries — collectives cross the Gloo transport,
jit inputs must be globalized (``put_if_multiprocess``), and only process
0 may touch the host observability surface.

Usage: python multihost_runner.py <proc_id> <port> <out_dir> <mode>
  mode: "host" (host batch pipeline + checkpointing),
        "device" (device pipeline + scanned dispatch, checkpoint off),
        "sharded" (2 devices per process, (2,2) model x data mesh with
        row-sharded tables — the 'model' axis is MAJOR in device order, so
        its groups pair device i of process 0 with device i of process 1
        and the shard_map lookup gather+psum crosses the process boundary),
        or the failure-recovery trio (SURVEY.md §5 — the reference loses
        the whole run on any crash, src/train.py:117-124):
        "failover_a" (long run, per-epoch latest/ snapshots — the parent
        test KILLS this pair mid-run), "failover_b" (same run dir,
        resume=True: must restore latest/ and finish), "failover_control"
        (uninterrupted same-length run in a fresh dir — the bit-for-bit
        yardstick the resumed run must match).
Prints one ``RESULT {json}`` line on success.
"""

import json
import sys


def main() -> None:
    proc_id, port, out_dir, mode = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4])
    import jax

    # must run before any backend use — the real-pod contract
    # (parallel/mesh.py::initialize_distributed wraps this for the CLI)
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=proc_id)
    assert jax.process_count() == 2, "distributed init fell back"
    n_local = 2 if mode == "sharded" else 1
    assert len(jax.devices()) == 2 * n_local
    assert len(jax.local_devices()) == n_local

    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.data.synthetic import synthetic_catalog
    from carca_tpu.train.loop import fit

    failover = mode.startswith("failover")
    cat = synthetic_catalog(n_users=320 if failover else 96,
                            n_real_items=60, seed=5)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=16, g=32, seq_len=8, target_len=12,
                     n_blocks=1, n_heads=2, dropout=0.0, decoder="ca")
    dc = DataConfig(synthetic=True,
                    device_pipeline=(mode in ("device", "sharded")))
    if mode == "sharded":
        tc = TrainConfig(batch_size=16, epochs=2, early_stop=10, seed=0,
                         out_dir=out_dir, mesh_shape=(2, 2),
                         mesh_axes=("model", "data"), shard_embeddings=True,
                         inner_steps=2, checkpoint=False)
    elif failover:
        # per-epoch latest/ snapshots; the _a phase runs "forever" (the
        # parent kills it), _b resumes it to 3 epochs, control runs the
        # same 3 epochs uninterrupted in its own directory
        tc = TrainConfig(batch_size=16,
                         epochs=99 if mode == "failover_a" else 3,
                         early_stop=50, seed=0, out_dir=out_dir,
                         mesh_shape=(2,), mesh_axes=("data",),
                         inner_steps=8, checkpoint=True,
                         checkpoint_interval=1,
                         checkpoint_resume=(mode == "failover_b"))
    else:
        tc = TrainConfig(batch_size=16, epochs=2, early_stop=10, seed=0,
                         out_dir=out_dir, mesh_shape=(2,), mesh_axes=("data",),
                         inner_steps=2 if mode == "device" else 8,
                         checkpoint=(mode == "host"))
    resumed_from = None
    if mode == "failover_b":
        # committed resume snapshots are pure-digit step dirs (a save
        # writes a .tmp-<step> dir and renames it on commit)
        import os as _os
        latest = _os.path.join(out_dir, "ckpt", "latest")
        steps = [int(d) for d in _os.listdir(latest) if d.isdigit()]
        resumed_from = max(steps)
        assert resumed_from >= 1, "no committed latest/ snapshot to resume"
    state, m = fit(Config(model=mc, data=dc, train=tc), cat)
    result = {"proc": proc_id,
              "val_hr": m["val_hr"], "val_ndcg": m["val_ndcg"],
              "test_ndcg": m["test_ndcg"], "epochs_run": m["epochs_run"]}
    if resumed_from is not None:
        result["resumed_from"] = resumed_from
    if mode == "sharded":
        # prove the items table really is row-sharded over the
        # cross-process 'model' axis: each process holds half the rows,
        # and a model-axis group spans both processes
        from carca_tpu.parallel.mesh import _is_table_path
        tables = [leaf for path, leaf in
                  jax.tree_util.tree_leaves_with_path(state.params)
                  if _is_table_path(path) and getattr(leaf, "ndim", 0) == 2]
        assert tables, "no items table found in params"
        tab = tables[0]
        assert "model" in str(tab.sharding.spec), tab.sharding
        # with 'model' MAJOR, this process's two local devices hold the
        # SAME half of the row space (they differ along 'data'); the other
        # half lives only on the peer process, so every lookup's
        # gather+psum crossed the transport. The test asserts the two
        # processes report different row windows.
        row_starts = sorted({s.index[0].start or 0
                             for s in tab.addressable_shards})
        row_rows = sorted({s.data.shape[0] for s in tab.addressable_shards})
        result["table_rows_global"] = int(tab.shape[0])
        result["local_row_start"] = [int(x) for x in row_starts]
        result["local_row_count"] = [int(x) for x in row_rows]
    print("RESULT " + json.dumps(result), flush=True)
    sys.stdout.flush()
    # Explicit shutdown + hard exit: leaving the distributed shutdown
    # barrier to interpreter teardown is flaky — a leaked non-daemon
    # thread (async machinery / grpc) can stall one process's
    # teardown past the 5-minute barrier deadline, and the coordination
    # service then kills BOTH processes (observed ~50% of runs with both
    # processes having already printed correct RESULTs). Reaching the
    # barrier while both processes are still symmetric is deterministic.
    import os

    jax.distributed.shutdown()
    os._exit(0)


if __name__ == "__main__":
    main()
