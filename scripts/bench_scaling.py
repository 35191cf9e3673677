"""DP weak-scaling harness: examples/sec/card at mesh sizes 1..N.

The north star asks for ≥85% examples/s scaling efficiency from 1 host to
N≥2 hosts. This is the tool that measures it: per mesh size, the global
batch grows linearly (weak scaling — per-chip work constant) through the
same `make_sharded_train_step` the trainer uses, and efficiency is
per-chip throughput relative to the single-device run.

`--platform native` runs each size on the cards JAX exposes (one child
process per size, one at a time; the parent stays off JAX so only one
process holds the cards). `--platform cpu` (the default) runs the harness
on N *virtual* CPU devices instead — those numbers validate the mechanics
(collectives inserted, per-device work constant), NOT hardware scaling:
the virtual devices share one host's cores, so ideal efficiency is ~1/N,
not 1.

    python scripts/bench_scaling.py --sizes 1,2,4,8 [--shard_embeddings]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def run_one(n_devices: int, args) -> dict:
    """Measure examples/sec on an n-device data mesh (child process)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from carca_tpu.config import ModelConfig, TrainConfig
    from carca_tpu.data.dataset import BatchBuilder
    from carca_tpu.data.synthetic import synthetic_catalog
    from carca_tpu.parallel import make_mesh, make_sharded_train_step
    from carca_tpu.train.state import create_train_state, make_optimizer

    model_par = 2 if (args.shard_embeddings and n_devices % 2 == 0) else 1
    if model_par > 1:
        mesh = make_mesh((n_devices // model_par, model_par),
                         ("data", "model"))
    else:
        mesh = make_mesh((n_devices,), ("data",))

    cat = synthetic_catalog(n_users=4096, n_real_items=2000, seed=0)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=64, g=256, seq_len=50,
                     target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
                     embedding="all", decoder="ca")
    data_axis = n_devices // model_par
    global_batch = args.per_chip_batch * data_axis
    tc = TrainConfig(batch_size=global_batch, seed=0)
    tx = make_optimizer(tc)
    state = create_train_state(jax.random.PRNGKey(0), mc, tc, tx)
    if model_par > 1:
        from carca_tpu.parallel.mesh import (pad_table_rows,
                                             prepare_state_for_mesh)
        state = prepare_state_for_mesh(state, mesh, tx)
        attrs = jnp.asarray(pad_table_rows(cat.attrs, mesh))
    else:
        attrs = jnp.asarray(cat.attrs)

    builder = BatchBuilder(cat, mc.seq_len, mc.target_len, test=True)
    rng = np.random.default_rng(0)
    rows = builder.users("train")
    rows = np.resize(rows, global_batch)
    batch = builder.train_batch(rows, rng)
    batch.pop("n_valid")

    step = make_sharded_train_step(mc, tx, mesh,
                                   shard_embeddings=model_par > 1)
    for _ in range(2):
        state, loss = step(state, attrs, batch)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, attrs, batch)
    jax.block_until_ready(loss)
    dt = time.perf_counter() - t0
    return {"devices": n_devices, "data_axis": data_axis, "global_batch": global_batch,
            "examples_per_sec": round(args.steps * global_batch / dt, 1)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--per_chip_batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shard_embeddings", action="store_true")
    ap.add_argument("--platform", default="cpu", choices=("cpu", "native"),
                    help="cpu = N virtual CPU devices per size; "
                         "native = the cards JAX exposes")
    ap.add_argument("--_child", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args._child:
        print(json.dumps(run_one(args._child, args)))
        return

    results = []
    for n in (int(s) for s in args.sizes.split(",")):
        env = dict(os.environ)
        if args.platform == "cpu":
            sys.path.insert(0, ROOT)
            from carca_tpu.utils.hostenv import virtual_cpu_env
            env = virtual_cpu_env(n)
        cmd = [sys.executable, os.path.abspath(__file__), "--_child", str(n),
               "--per_chip_batch", str(args.per_chip_batch),
               "--steps", str(args.steps)]
        if args.shard_embeddings:
            cmd.append("--shard_embeddings")
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=1800, cwd=ROOT)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-2000:])
            raise RuntimeError(f"size {n} failed")
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))

    # per-chip = per DATA-axis chip (the per-chip batch is defined per
    # data shard; model shards split the lookup, not the batch), and the
    # efficiency baseline is the SMALLEST size actually run
    def data_chips(r):
        return r.get("data_axis", r["devices"])

    base = results[0]["examples_per_sec"] / data_chips(results[0])
    base_n = results[0]["devices"]
    for r in results:
        per_chip = r["examples_per_sec"] / data_chips(r)
        r["per_chip"] = round(per_chip, 1)
        r[f"efficiency_vs_{base_n}dev"] = round(per_chip / base, 3)
        print(json.dumps(r))


if __name__ == "__main__":
    main()
