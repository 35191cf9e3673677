"""JSON-lines serving loop + latency bench (``carca-serve``).

Dependency-free process-level serving: requests arrive one JSON object per
stdin line, responses leave one JSON object per stdout line — the shape
that slots behind any RPC front-end (or a shell pipe) without pulling a web
framework into the training image.

Request:  {"history": [item_id, ...], "k": 10, "ctx": [...], "id": any}
      or  {"user": <row>, ...}        (history looked up in the catalog)
Response: {"items": [...], "scores": [...], "id": any}

``--bench`` skips stdin and measures steady-state latency per batch bucket
(p50/p95/p99 over ``--iters`` timed calls after warmup).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="carca-serve", description=__doc__)
    p.add_argument("--run_dir", required=True,
                   help="training output dir (args.json + ckpt/)")
    p.add_argument("--which", choices=("best", "latest"), default="best")
    p.add_argument("--data_dir", default="", help="catalog location "
                   "(reference file formats); default: synthetic catalog "
                   "regenerated from the run's data config")
    p.add_argument("--profile_file", default="")
    p.add_argument("--attr_file", default="")
    p.add_argument("--ctx_file", default="")
    p.add_argument("--shortlist", type=int, default=512)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--no_exclude_history", action="store_true",
                   help="allow already-seen items in results")
    p.add_argument("--index", choices=("seen", "full"), default="seen",
                   help="stage-1 retrieval index: seen = items with >=1 "
                        "catalog event (production posture, far less "
                        "catalog streaming at high sparsity); full = the "
                        "whole id space")
    p.add_argument("--quantize_index", type=str, default="auto",
                   choices=("true", "false", "auto"),
                   help="int8 stage-1 index (1/4 the catalog scan per "
                        "request; rerank re-scores exactly). auto = "
                        "quantize indexes of >=1M rows")
    p.add_argument("--index_shards", type=int, default=1,
                   help="row-shard the stage-1 index over this many chips "
                        "(a 'model' mesh axis) — for indexes beyond one "
                        "chip's HBM")
    p.add_argument("--max_k", type=int, default=100,
                   help="cap on per-request k (each distinct k compiles one "
                        "executable; the cap bounds that)")
    p.add_argument("--warmup", action="store_true",
                   help="compile all batch buckets before serving")
    p.add_argument("--bench", action="store_true",
                   help="measure latency instead of serving stdin")
    p.add_argument("--iters", type=int, default=50)
    return p


def load_catalog_for_run(args, cfg):
    if args.data_dir:
        from carca_tpu.data.loaders import load_dataset
        return load_dataset(args.data_dir, args.profile_file,
                            args.attr_file, args.ctx_file)
    from carca_tpu.data.synthetic import synthetic_generator
    d = cfg.data
    # a device_pipeline training run generated its catalog with the device
    # PRNG (cli.load_catalog) — regenerate with the same generator (and
    # the same process, zipf vs markov) or the served attrs/contexts
    # won't match the trained tables
    gen = synthetic_generator(d.synthetic_process, device=d.device_pipeline)
    return gen(n_users=d.synthetic_users, n_real_items=d.synthetic_items,
               seed=d.synthetic_seed)


class _HostCSR:
    """Host-side copies of the catalog's CSR arrays: per-request history
    lookups must not slice device arrays (each slice is a dispatch plus a
    device→host copy on the latency-critical path)."""

    def __init__(self, cat):
        self.items = np.asarray(cat.items)
        self.ctx_vals = np.asarray(cat.ctx_vals)
        self.offsets = np.asarray(cat.offsets)
        self.n_users = cat.n_users


def _history(cat, user: int):
    # explicit bounds check: numpy negative indexing would silently wrap
    # a negative "user" to ANOTHER user's CSR range
    if not 0 <= user < cat.n_users:
        raise ValueError(f"user {user} out of range [0, {cat.n_users})")
    lo, hi = int(cat.offsets[user]), int(cat.offsets[user + 1])
    return cat.items[lo:hi].tolist(), cat.ctx_vals[lo:hi]


def run_bench(rec, cat, k: int, iters: int) -> None:
    rng = np.random.default_rng(0)
    for bb in rec.batch_buckets:
        users = rng.integers(0, cat.n_users, size=bb)
        hists, ctxs = zip(*(_history(cat, int(u)) for u in users))
        rec.recommend(hists, k=k, ctxs=ctxs)  # compile + warm
        lat = []
        for _ in range(iters):
            t0 = time.perf_counter()
            rec.recommend(hists, k=k, ctxs=ctxs)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.sort(np.asarray(lat))
        pct = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))])
        print(json.dumps({
            "batch": bb, "k": k,
            "p50_ms": round(pct(0.50), 3),
            "p95_ms": round(pct(0.95), 3),
            "p99_ms": round(pct(0.99), 3),
            "throughput_users_per_sec": round(bb / (pct(0.50) / 1e3), 1),
        }))


def main(argv: Optional[list] = None) -> None:
    # a restarted server with a warm cache skips the bucket compiles
    from carca_tpu.utils.hostenv import enable_compilation_cache
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    from carca_tpu.serve.recommender import (config_from_run_dir,
                                             load_recommender)

    cfg = config_from_run_dir(args.run_dir)
    cat = load_catalog_for_run(args, cfg)
    host = _HostCSR(cat)
    mesh = None
    if args.index_shards > 1:
        import jax

        from carca_tpu.parallel.mesh import make_mesh
        n_dev = len(jax.devices())
        if args.index_shards > n_dev:
            # jax.devices()[:N] would silently yield fewer devices and
            # make_mesh would fail with a confusing shape error
            raise SystemExit(
                f"--index_shards {args.index_shards} exceeds the "
                f"{n_dev} available device(s)")
        mesh = make_mesh((args.index_shards,), ("model",),
                         devices=jax.devices()[: args.index_shards])
    rec = load_recommender(
        args.run_dir, cat.attrs, which=args.which,
        shortlist=args.shortlist,
        exclude_history=not args.no_exclude_history,
        index_ids=np.unique(host.items) if args.index == "seen" else None,
        quantize={"true": True, "false": False,
                  "auto": "auto"}[args.quantize_index],
        mesh=mesh)
    if args.warmup or args.bench:
        rec.warmup(k=args.k)
    if args.bench:
        run_bench(rec, host, args.k, args.iters)
        return

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = None
        try:
            req = json.loads(line)
            if "history" in req:
                hist, ctx = req["history"], req.get("ctx")
            else:
                hist, ctx = _history(host, int(req["user"]))
            k = max(1, min(int(req.get("k", args.k)), args.max_k))
            ids, scores = rec.recommend(
                [hist], k=k,
                ctxs=[ctx] if ctx is not None else None,
                request_ctx=(np.asarray(req["request_ctx"], np.float32)
                             if "request_ctx" in req else None))
            # padded/exhausted slots carry -inf, which is not valid JSON —
            # drop them (fewer than k finite candidates is a real outcome
            # on small catalogs / heavy history exclusion)
            keep = np.isfinite(scores[0])
            out = {"items": ids[0][keep].tolist(),
                   "scores": [round(float(s), 6) for s in scores[0][keep]]}
        except Exception as exc:  # malformed request must not kill the loop
            out = {"error": f"{type(exc).__name__}: {exc}"}
        if isinstance(req, dict) and "id" in req:
            out["id"] = req["id"]
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
