"""Run the train → serve path once on the GPU and check every result.

    python chip_smoke.py              # phases 0-4, one card
    python chip_smoke.py --multichip  # the 4-card phase only

One process holds the card(s). Phases, each checked against the repo's own
reference; any failure exits non-zero before the last line:

0. device — the JAX backend must be the GPU (anything else exits non-zero
   at once); prints the JAX version, devices, compile-cache directory and
   ``nvidia-smi``'s card name and power limit.
1. train — ``carca_tpu.cli.main`` at the flagship width (d=64, g=256, 2
   blocks, 2 heads, L=50, 100 targets, cross-attention decoder, ``all``
   embedding, dropout 0.5; batch 256, synthetic 4096 users × 2000 items,
   device pipeline), 2 epochs with checkpoints, then a third epoch with
   ``--resume true``: losses finite, and the resume continues from the
   saved step.
2. serve — ``load_recommender`` on that run; batch 1 and batch 256
   requests (512-item shortlist from the stage-1 kernel, reranked by the
   cross-attention decoder) against the same recommender with the plain
   XLA stage 1.
3. retrieval kernel — a dot-decoder model with random weights at the
   ``synthetic10m`` shape (10,000,001 items, d=64): 256 queries, k=10 and
   k=60, f32 / bf16 / int8 indexes, against ``_masked_scores`` +
   ``lax.top_k`` at "highest" precision.
4. numerics — the flagship forward (``__graft_entry__.entry``) on the GPU
   against the CPU in this process: within 1e-4 relative at "highest"
   (gated); the TF32 difference at default precision is printed.

``--multichip`` (4 cards): the flagship width trained under ``--mesh 2x2
--shard_embeddings true`` against one card (dropout 0, same batches and
seed; epoch losses within 1e-4 relative), and the 10M-item int8 index
row-sharded over ``model=4`` against the single-device index (same ids).

The last stdout line is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = ["--synthetic", "true", "--d_dim", "64", "--g_dim", "256",
            "--n_blocks", "2", "--n_heads", "2", "--seq_len", "50",
            "--target_seq_len", "100", "--decoder", "ca",
            "--embedding", "all", "--batch_size", "256"]
ITEMS_10M = 10_000_000  # real items; the pad row makes 10,000,001 ids


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card() -> str:
    """``name, power.limit`` of the card(s), from nvidia-smi (off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase_device() -> None:
    from carca_tpu.utils.hostenv import enable_compilation_cache
    cache = enable_compilation_cache()
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs the GPU; JAX's backend is "
                         f"{backend!r}")
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    log(f"compile cache: {cache}")
    log(f"card: {card()}")


def _epochs(run: str):
    """[(epoch, train_loss)] from the run's metrics.jsonl."""
    out = []
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if "train_loss" in rec:
                out.append((rec["epoch"], rec["train_loss"]))
    return out


def _saved_step(run: str):
    """(epoch, optimizer step) of the run's latest/ checkpoint."""
    latest = os.path.join(run, "ckpt", "latest")
    [epoch] = [int(n) for n in os.listdir(latest) if n.isdigit()]
    with open(os.path.join(latest, str(epoch), "manifest.json")) as fh:
        paths = [leaf["path"] for leaf in json.load(fh)["leaves"]]
    step = np.load(os.path.join(latest, str(epoch),
                                f"{paths.index('.step')}.npy"))
    return epoch, int(step)


def phase_train(run: str, flags=FLAGSHIP, users: int = 4096,
                items: int = 2000) -> None:
    from carca_tpu import cli

    base = flags + ["--synthetic_users", str(users), "--synthetic_items",
                    str(items), "--dropout", "0.5", "--device_pipeline",
                    "true", "--out_dir", run]
    t0 = time.perf_counter()
    cli.main(base + ["--epochs", "2", "--resume", "false"])
    first = _epochs(run)
    e2, s2 = _saved_step(run)
    cli.main(base + ["--epochs", "3", "--resume", "true"])
    both = _epochs(run)
    e3, s3 = _saved_step(run)
    log(f"train: epoch losses {both}; latest checkpoint epoch {e2} step "
        f"{s2} -> epoch {e3} step {s3} ({time.perf_counter() - t0:.1f} s)")
    check([e for e, _ in first] == [1, 2], f"2-epoch run logged {first}")
    check([e for e, _ in both] == [1, 2, 3],
          f"resume did not continue at epoch 3: {both}")
    check(all(np.isfinite(loss) for _, loss in both), f"losses {both}")
    check(e2 == 2 and e3 == 3 and s2 > 0 and 2 * s3 == 3 * s2,
          f"resume did not continue from the saved step ({s2} -> {s3})")


def _same_ranking(ids, vals, ref_ids, ref_vals, rtol: float) -> int:
    """Positions where the ids differ must be near-ties (values within
    ``rtol``); returns how many such swaps there were."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    vals, ref_vals = np.asarray(vals), np.asarray(ref_vals)
    diff = ids != ref_ids
    tie = np.abs(vals - ref_vals) <= rtol * np.maximum(np.abs(ref_vals), 1.0)
    check(bool(np.all(tie | ~diff)),
          f"ids differ beyond ties at {np.argwhere(diff & ~tie)[:5]}")
    return int(diff.sum())


def phase_serve(run: str, batches=(1, 256)) -> None:
    import jax

    from carca_tpu.cli import load_catalog
    from carca_tpu.serve.recommender import (Recommender, config_from_run_dir,
                                             load_recommender)

    cfg = config_from_run_dir(run)
    cat = load_catalog(None, cfg.data)
    rec = load_recommender(run, cat.attrs, shortlist=512)
    ref = Recommender(rec.params, cfg.model, cat.attrs, shortlist=512,
                      use_kernel=False)
    items, offsets = np.asarray(cat.items), np.asarray(cat.offsets)
    for b in batches:
        hists = [items[offsets[u]:offsets[u + 1]].tolist() for u in range(b)]
        with jax.default_matmul_precision("highest"):
            t0 = time.perf_counter()
            ids, vals = rec.recommend(hists, k=10)
            dt = time.perf_counter() - t0
            ref_ids, ref_vals = ref.recommend(hists, k=10)
        check(ids.shape == (b, 10) and np.isfinite(vals).all()
              and (ids > 0).all(), f"batch {b}: malformed result")
        swaps = _same_ranking(ids, vals, ref_ids, ref_vals, 1e-5)
        log(f"serve: batch {b} ids match the plain stage 1 ({swaps} tie "
            f"swaps; first call {dt:.2f} s incl. compile)")


def _queries(params, mc, cat, b: int):
    """Queries of the first ``b`` users of ``cat`` (their histories)."""
    import jax

    from carca_tpu.parallel.retrieval import queries
    from carca_tpu.serve.recommender import pad_histories

    items, offsets = np.asarray(cat.items), np.asarray(cat.offsets)
    ctx = np.asarray(cat.ctx_vals[: int(offsets[b])])
    hists = [items[offsets[u]:offsets[u + 1]] for u in range(b)]
    ctxs = [ctx[offsets[u]:offsets[u + 1]] for u in range(b)]
    p_x, p_c = pad_histories(hists, mc.seq_len, ctxs, mc.n_ctx)
    return jax.jit(lambda p, a: queries(p, mc, (p_x, None, p_c), a))(
        params, cat.attrs)


def _index_model(n_real_items: int, users: int):
    """Random-weight dot model at the synthetic10m shape + its f32
    decoder-space catalog and ``users`` queries."""
    import jax

    from carca_tpu.config import preset
    from carca_tpu.data.synthetic import synthetic_catalog_device
    from carca_tpu.models.carca import carca_init
    from carca_tpu.parallel.retrieval import (catalog_in_decoder_space,
                                              embed_catalog)

    cat = synthetic_catalog_device(n_users=users, n_real_items=n_real_items,
                                   seed=0)
    mc = preset("synthetic10m", cat.n_items, cat.n_attrs, cat.n_ctx).model
    params = carca_init(jax.random.PRNGKey(0), mc)
    e = jax.jit(lambda p, a: catalog_in_decoder_space(
        embed_catalog(p, mc, a), mc))(params, cat.attrs)
    return mc, e, _queries(params, mc, cat, users)


def _reference_topk(q, rows, k: int, n_items: int, block: int = 32):
    """``_masked_scores`` + ``lax.top_k`` at "highest", ``block`` queries
    at a time (one top_k over [256, 10M] exceeds int32 indexing)."""
    import jax
    import jax.numpy as jnp

    from carca_tpu.parallel.retrieval import _masked_scores

    ids = jnp.arange(rows.shape[0], dtype=jnp.int32)
    ids = jnp.where(ids < n_items, ids, 0)

    @jax.jit
    def run(q, rows):
        def one(qb):
            return jax.lax.top_k(_masked_scores(qb, rows, ids, None), k)
        v, i = jax.lax.map(one, q.reshape(-1, block, q.shape[1]))
        return v.reshape(-1, k), i.reshape(-1, k)

    with jax.default_matmul_precision("highest"):
        return run(q, rows)


def phase_retrieval(n_real_items: int = ITEMS_10M, b: int = 256,
                    ks=(10, 60)) -> None:
    import jax
    import jax.numpy as jnp

    from carca_tpu.ops.retrieval_topk import (catalog_topk, dequantize_index,
                                              quantize_index)

    t0 = time.perf_counter()
    mc, e, q = _index_model(n_real_items, b)
    jax.block_until_ready((e, q))
    log(f"retrieval: {e.shape[0]} x {e.shape[1]} catalog embedded, {b} "
        f"queries ({time.perf_counter() - t0:.1f} s)")
    n = mc.n_items
    q16 = q.astype(jnp.bfloat16).astype(jnp.float32)
    for name in ("f32", "bf16", "int8"):
        if name == "f32":
            index, rows, qref = e, e, q
        elif name == "bf16":
            index = e.astype(jnp.bfloat16)
            rows, qref = index.astype(jnp.float32), q16
        else:
            index = jax.jit(quantize_index)(e)
            rows, qref = jax.jit(dequantize_index)(index), q16
        for k in ks:
            topk = jax.jit(lambda qq, ix, k=k: catalog_topk(qq, ix, k,
                                                            n_items=n))
            v, ids = topk(q, index)
            rv, ri = _reference_topk(qref, rows, k, n)
            v, ids, rv, ri = map(np.asarray, (v, ids, rv, ri))
            err = float(np.max(np.abs(v - rv)))
            check(v.shape == (b, k) and (ids > 0).all() and (ids < n).all(),
                  f"{name} k={k}: malformed result")
            if name == "f32":
                # ids equal except where two reference scores lie within
                # 1e-6 relative of each other
                swaps = _same_ranking(ids, v, ri, rv, 1e-6)
            else:
                np.testing.assert_allclose(v, rv, rtol=1e-5, atol=1e-5)
                swaps = int((ids != ri).sum())
            log(f"retrieval: {name} k={k} max |value - reference| {err:.3e}"
                f", {swaps} id swaps at near-ties")
        del index, rows


def phase_numerics() -> None:
    import jax

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    cpu_args = jax.device_put(args, jax.devices("cpu")[0])
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(jax.jit(fn)(*args))
        ref = np.asarray(jax.jit(fn)(*cpu_args))
    default = np.asarray(jax.jit(fn)(*args))
    scale = float(np.max(np.abs(ref)))
    rel_hi = float(np.max(np.abs(hi - ref))) / scale
    rel_default = float(np.max(np.abs(default - ref))) / scale
    log(f"numerics: GPU vs CPU logits, max |diff| / max |logit|: highest "
        f"{rel_hi:.3e} (gate 1e-4), default precision {rel_default:.3e}")
    check(hi.shape == ref.shape and np.isfinite(hi).all(), "bad logits")
    check(rel_hi <= 1e-4, f"GPU logits differ from the CPU's: {rel_hi:.3e}")


def phase_multichip(run_dir: str, users: int = 1024, items: int = 2000,
                    n_real_items: int = ITEMS_10M, b: int = 256,
                    k: int = 10) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from carca_tpu import cli
    from carca_tpu.ops.retrieval_topk import QuantizedIndex, quantize_index
    from carca_tpu.parallel.mesh import make_mesh
    from carca_tpu.parallel.retrieval import (topk_given_queries,
                                              topk_given_queries_sharded)

    check(len(jax.devices()) >= 4, f"needs 4 devices, has {jax.devices()}")
    base = FLAGSHIP + ["--synthetic_users", str(users), "--synthetic_items",
                       str(items), "--dropout", "0", "--epochs", "1",
                       "--checkpoint", "false", "--test", "false"]
    losses = {}
    for name, extra in (("1 card", []),
                        ("mesh 2x2", ["--mesh", "2x2",
                                      "--shard_embeddings", "true"])):
        run = os.path.join(run_dir, name.replace(" ", "_"))
        with jax.default_matmul_precision("highest"):
            cli.main(base + extra + ["--out_dir", run])
        losses[name] = _epochs(run)[0][1]
    one, mesh = losses["1 card"], losses["mesh 2x2"]
    rel = abs(one - mesh) / abs(one)
    log(f"multichip: epoch-1 train loss 1 card {one!r} vs mesh 2x2 "
        f"{mesh!r} (relative difference {rel:.3e}, gate 1e-4)")
    check(np.isfinite(one) and rel <= 1e-4, "mesh loss diverged")

    mc, e, q = _index_model(n_real_items, b)
    qi = jax.jit(quantize_index)(e)
    del e
    v0, i0 = jax.jit(lambda qq, ix: topk_given_queries(
        qq, ix, mc, k, in_decoder_space=True))(q, qi)
    mesh4 = make_mesh((4,), ("model",), devices=jax.devices()[:4])
    pad = (-qi.rows) % 4
    padded = QuantizedIndex(
        jax.numpy.pad(qi.qvals, ((0, pad), (0, 0))),
        jax.numpy.pad(qi.scales, ((0, 0), (0, pad))))
    sharded = jax.device_put(padded, QuantizedIndex(
        NamedSharding(mesh4, P("model", None)),
        NamedSharding(mesh4, P(None, "model"))))
    del qi, padded
    q4 = jax.device_put(q, NamedSharding(mesh4, P()))
    v1, i1 = jax.jit(lambda qq, ix: topk_given_queries_sharded(
        qq, ix, mc, k, mesh4))(q4, sharded)
    # the shards run the same kernel on the same rows: ids may differ
    # only between exactly equal scores
    swaps = _same_ranking(i1, v1, i0, v0, 0.0)
    log(f"multichip: {n_real_items + 1}-id int8 index over model=4 returns "
        f"the single-device ids ({b} queries, k={k}, {swaps} swaps between "
        f"equal scores)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-card phase")
    args = ap.parse_args(argv)
    phase_device()
    import jax

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.multichip:
            phase_multichip(tmp)
        else:
            run = os.path.join(tmp, "flagship")
            phase_train(run)
            phase_serve(run)
            phase_retrieval()
            phase_numerics()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"card: {card()}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
