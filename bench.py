"""Headline benchmark: train throughput (examples/sec/card) on the GPU.

Default (no args) is the flagship config — 2-block CARCA d=64, seq 50,
cross-attention decoder, batch 256 —
compared against the measured reference throughput in
BASELINE_MEASURED.json (the reference repo publishes no numbers —
SURVEY.md §6; we measured its PyTorch training loop on this host's CPU).
``--config men`` switches to the long-sequence shape (L=200, BASELINE
configs[3]) and compares against VALIDATION_men_ref.json instead.
``--batch N`` overrides the batch size; when N != 256 the JSON line gains a
``batch`` field since the baseline was measured at 256.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
     "mfu": ..., "hbm_bw_util": ..., "device": {...}}

``mfu`` divides the analytic matmul FLOPs by the card's tensor-core peak
for the model's compute dtype (TF32 for f32, bf16 for bf16 —
``utils/flops.py``); an unknown card raises rather than printing none.

``vs_baseline`` falls back to 1.0 when the baseline file is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_setup(config: str, batch: int):
    """Model + scanned device-pipeline step for one headline config —
    shared by this benchmark and ``scripts/profile_step.py`` so the
    profiler always profiles exactly the model being benchmarked.

    Returns (step, state, attrs, dd, chunks, inner, tc, mc); ``chunks`` are
    four [inner, B] user-row matrices of full (unpadded) batches.
    """
    from carca_tpu.config import ModelConfig, TrainConfig
    from carca_tpu.data.dataset import epoch_batches
    from carca_tpu.data.device_pipeline import DeviceDataset
    from carca_tpu.data.synthetic import synthetic_catalog
    from carca_tpu.train.loop import (attrs_dtype,
                                      make_scanned_device_train_step)
    from carca_tpu.train.state import create_train_state, make_optimizer

    if config == "men":
        cat = synthetic_catalog(n_users=2048, n_real_items=2000, n_attrs=12,
                                n_ctx=4, min_len=40, max_len=250, seed=0)
        seq_len = 200
    elif config == "10m":
        from carca_tpu.data.synthetic import synthetic_catalog_device
        cat = synthetic_catalog_device(n_users=100_000,
                                       n_real_items=10_000_000, seed=0)
        seq_len = 50
    else:
        cat = synthetic_catalog(n_users=4096, n_real_items=2000, seed=0)
        seq_len = 50
    at_scale = config == "10m"
    mc = ModelConfig(
        n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
        d=64, g=256, seq_len=seq_len, target_len=100, n_blocks=2, n_heads=2,
        dropout=0.5, embedding="all", encoding="identity",
        decoder="dot" if at_scale else "ca",
        compute_dtype="bfloat16" if at_scale else "float32",
    )
    tc = TrainConfig(batch_size=batch, seed=0)
    tx = make_optimizer(tc)
    state = create_train_state(jax.random.PRNGKey(0), mc, tc, tx,
                               sparse_items=at_scale)
    attrs = jnp.asarray(cat.attrs, attrs_dtype(mc))

    # production path: HBM-resident catalog, batches assembled on device
    # (per-dispatch host→device traffic is one [K, B] user-row matrix),
    # inner_steps train steps fused into each dispatch via lax.scan
    dd = DeviceDataset(cat, mc.seq_len, mc.target_len, test=True)
    users = dd.users("train")
    rng = np.random.default_rng(0)
    inner = tc.inner_steps
    # full batches only: the last partial batch carries -1 pad rows the
    # assembler masks out, which would inflate the examples/sec numerator
    rows = [r for r in epoch_batches(users, tc.batch_size, rng, shuffle=True)
            if (r >= 0).all()]
    if not rows:
        raise SystemExit(
            f"--batch {batch} exceeds the config's user count "
            f"({len(users)}): no full batch to measure")
    chunks = [jnp.asarray(np.stack([rows[(j * inner + i) % len(rows)]
                                    for i in range(inner)]), jnp.int32)
              for j in range(4)]
    step = make_scanned_device_train_step(mc, tx, inner,
                                          sparse_items=at_scale, tc=tc)
    return step, state, attrs, dd, chunks, inner, tc, mc


def main() -> None:
    from carca_tpu.utils.hostenv import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=("flagship", "men", "10m"),
                    default="flagship",
                    help="men = long-sequence shape (L=200, BASELINE "
                         "configs[3]); reference measured 52.16 ex/s there "
                         "(VALIDATION_men_ref.json). 10m = the 10M-item "
                         "catalog shape (BASELINE configs[4]): device-"
                         "generated catalog, bf16 compute, lazy "
                         "sparse Adam — no reference counterpart (its "
                         "torch-CPU loop cannot hold the table)")
    ap.add_argument("--batch", type=int, default=256,
                    help="train batch size (256 matches the reference "
                         "measurement; larger shows production throughput)")
    args = ap.parse_args()

    at_scale = args.config == "10m"
    step, state, attrs, dd, chunks, inner, tc, mc = build_setup(
        args.config, args.batch)

    for i in range(2):  # warmup + compile
        state, losses = step(state, attrs, dd.arrays, chunks[i % len(chunks)])
    jax.block_until_ready(losses)

    # median of N timed windows: the median is stable where single
    # windows jitter
    n_windows = 5
    n_calls = max(1, 100 // inner)
    rates = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for i in range(n_calls):
            state, losses = step(state, attrs, dd.arrays,
                                 chunks[i % len(chunks)])
        jax.block_until_ready(losses)
        dt = time.perf_counter() - t0
        rates.append(n_calls * inner * tc.batch_size / dt)

    examples_per_sec = statistics.median(rates)

    # MFU: analytic matmul FLOPs/step over measured step time vs the
    # card's peak for the compute dtype (utils/flops.py) — utilization
    # context the raw vs-torch-CPU ratio can't give
    from carca_tpu.utils.flops import (device_peak_flops,
                                       device_peak_hbm_bps,
                                       train_step_flops,
                                       train_step_hbm_bytes)
    dev = jax.devices()[0]
    peak = device_peak_flops(dev, mc.compute_dtype)
    mfu = (train_step_flops(mc, tc.batch_size) * examples_per_sec
           / tc.batch_size / peak)

    # bandwidth roofline companion to MFU: modeled HBM bytes/step
    # (optimizer+grad streams, table gathers/scatters, batch IO, fwd
    # intermediates — utils/flops.py caveats) at the measured step rate,
    # plus XLA's own bytes-accessed estimate of the compiled executable
    # when the backend exposes one (cross-check; includes what fusion
    # actually kept in HBM)
    steps_per_sec = examples_per_sec / tc.batch_size
    hbm_gbps = (train_step_hbm_bytes(mc, tc.batch_size,
                                     sparse_items=at_scale)
                * steps_per_sec / 1e9)
    hbm_peak = device_peak_hbm_bps(dev)
    xla_gbps = None
    try:
        ca = step.lower(state, attrs, dd.arrays, chunks[0]).compile()
        cost = ca.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        xla_bytes = float(cost["bytes accessed"]) / inner
        xla_gbps = xla_bytes * steps_per_sec / 1e9
    except Exception:
        pass  # backend without cost_analysis (or non-jit step)

    baseline = None
    base_file = ("VALIDATION_men_ref.json" if args.config == "men"
                 else None if at_scale  # no reference counterpart at 10M
                 else "BASELINE_MEASURED.json")
    if base_file is not None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            base_file)
        if os.path.exists(path):
            with open(path) as fh:
                baseline = json.load(fh).get("train_examples_per_sec")

    out = {
        "metric": f"train_examples_per_sec_{args.config}",
        "value": round(examples_per_sec, 1),
        "unit": "examples/sec/card",
        "vs_baseline": round(examples_per_sec / baseline, 3) if baseline else 1.0,
    }
    # variance context so round-over-round comparisons can tell jitter
    # from regression (the round-2 lesson), plus utilization context
    out["rates"] = {"min": round(min(rates), 1),
                    "median": round(examples_per_sec, 1),
                    "max": round(max(rates), 1)}
    out["mfu"] = round(mfu, 4)
    out["hbm_gbps"] = round(hbm_gbps, 1)
    if xla_gbps is not None:
        out["hbm_gbps_xla"] = round(xla_gbps, 1)
    out["hbm_bw_util"] = round(
        max(hbm_gbps, xla_gbps or 0.0) * 1e9 / hbm_peak, 4)
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    if args.batch != 256:  # reference was measured at 256
        out["batch"] = args.batch
    print(json.dumps(out))


if __name__ == "__main__":
    main()
