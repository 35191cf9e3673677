"""Serving-latency benchmark: two-stage recommend() on the flagship model.

Measures steady-state end-to-end request latency (host padding + H2D +
profile encode + streaming catalog top-k + CA rerank + D2H) per batch
bucket, on whatever accelerator JAX exposes. The reference has no serving
path to compare against; these are the framework's own SLO numbers.

    python scripts/bench_serving.py [--items 100000] [--shortlist 512]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=100_000)
    ap.add_argument("--users", type=int, default=4096)
    ap.add_argument("--shortlist", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--decoder", default="ca", choices=("ca", "dot", "wdot"))
    ap.add_argument("--quantize", default="false",
                    choices=("true", "false", "auto"),
                    help="int8 stage-1 index (Recommender quantize flag)")
    args = ap.parse_args()

    from carca_tpu.config import ModelConfig
    from carca_tpu.data.synthetic import synthetic_catalog
    from carca_tpu.models.carca import carca_init
    from carca_tpu.serve.recommender import Recommender

    cat = synthetic_catalog(n_users=args.users,
                            n_real_items=args.items - 1, seed=0)
    mc = ModelConfig(n_items=cat.n_items, n_attrs=cat.n_attrs,
                     n_ctx=cat.n_ctx, d=64, g=256, seq_len=50,
                     target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
                     embedding="all", encoding="identity",
                     decoder=args.decoder)
    params = carca_init(jax.random.PRNGKey(0), mc)

    t0 = time.perf_counter()
    quant = {"true": True, "false": False, "auto": "auto"}[args.quantize]
    rec = Recommender(params, mc, cat.attrs, shortlist=args.shortlist,
                      batch_buckets=(1, 8, 64, 256), quantize=quant)
    jax.block_until_ready(rec.catalog_emb)
    load_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    print(json.dumps({"catalog_items": mc.n_items, "decoder": args.decoder,
                      "shortlist": args.shortlist, "quantize": args.quantize,
                      "catalog_embed_s": round(load_s, 2),
                      "device": jax.devices()[0].platform}))
    for bb in rec.batch_buckets:
        users = rng.integers(0, cat.n_users, size=bb)
        hists = [cat.items[cat.offsets[u]:cat.offsets[u + 1]].tolist()
                 for u in users]
        for _ in range(3):
            rec.recommend(hists, k=args.k)  # compile + warm
        lat = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            rec.recommend(hists, k=args.k)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.sort(np.asarray(lat))
        pct = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))])
        print(json.dumps({
            "batch": bb, "k": args.k,
            "p50_ms": round(pct(0.50), 2),
            "p95_ms": round(pct(0.95), 2),
            "p99_ms": round(pct(0.99), 2),
            "users_per_sec": round(bb / (np.mean(lat) / 1e3), 1),
        }))


if __name__ == "__main__":
    main()
