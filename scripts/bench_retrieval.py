"""Full-catalog retrieval benchmark: tournament top-k with the Pallas
stage-1 kernel against the same tournament with a plain-jnp stage 1.

A dot-decoder model with random weights embeds a synthetic catalog of
``--items`` rows once (``embed_catalog``, attrs made on the device), and
its profile encoder turns ``--batch`` random histories into queries. Each
leg then ranks the whole catalog for those queries
(``ops/retrieval_topk.catalog_topk``):

* ``kernel`` — stage 1 is the Pallas (Triton route) group-max kernel;
* ``plain``  — stage 1 is ``groupmax_plain``: a ``lax.map`` over catalog
  chunks of ``max((q @ e_chunk.T).reshape(B, -1, 128), -1)``, left to XLA.

Both for f32, bf16 and int8 (``QuantizedIndex``) catalogs, at each ``--k``
(the serving slack for a 50-event exclusion list makes k=60 the realistic
second point). Legs alternate in rounds (kernel, plain, plain, kernel, …)
and each reports the median over rounds of the mean call time; stage 1
alone is timed the same way. Prints the card's name and power limit first
and one JSON line per (dtype, k, leg).

    python scripts/bench_retrieval.py [--items 10000001] [--batch 256]
        [--k 10 60] [--dtypes f32 bf16 int8] [--rounds 4] [--calls 10]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def card() -> str:
    """``name, power.limit`` from nvidia-smi (a child process, off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _mean_ms(fn, args, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / calls * 1e3


def main() -> None:
    from carca_tpu.utils.hostenv import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=10_000_001)
    ap.add_argument("--attrs", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, nargs="+", default=[10, 60])
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--seq_len", type=int, default=50)
    ap.add_argument("--dtypes", nargs="+", default=["f32", "bf16", "int8"],
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs the GPU (backend is "
                         f"{jax.default_backend()!r}): the kernel leg "
                         f"would run the Pallas interpreter")
    print(f"# card: {card()}", flush=True)

    from carca_tpu.config import ModelConfig
    from carca_tpu.models.carca import carca_init
    from carca_tpu.ops.retrieval_topk import (catalog_topk, groupmax_kernel,
                                              groupmax_plain, quantize_index)
    from carca_tpu.parallel.retrieval import (catalog_in_decoder_space,
                                              embed_catalog, queries)

    mc = ModelConfig(
        n_items=args.items, n_attrs=args.attrs, n_ctx=8, d=args.d, g=256,
        seq_len=args.seq_len, n_blocks=2, n_heads=2, dropout=0.0,
        embedding="all", decoder="dot")
    params = carca_init(jax.random.PRNGKey(0), mc)
    k_a, k_x, k_c = jax.random.split(jax.random.PRNGKey(1), 3)
    b = args.batch
    attrs, p_x, p_c = jax.jit(lambda: (
        jax.random.normal(k_a, (args.items, args.attrs), jnp.float32),
        jax.random.randint(k_x, (b, mc.seq_len), 1, args.items, jnp.int32),
        jax.random.normal(k_c, (b, mc.seq_len, mc.n_ctx), jnp.float32)))()
    t0 = time.perf_counter()
    e = jax.jit(lambda p, a: catalog_in_decoder_space(
        embed_catalog(p, mc, a), mc))(params, attrs)
    q = jax.jit(lambda p, a: queries(p, mc, (p_x, None, p_c), a))(params,
                                                                  attrs)
    jax.block_until_ready((e, q))
    print(f"# catalog {args.items} x {args.d} embedded in "
          f"{time.perf_counter() - t0:.3f} s (compile included)", flush=True)
    del attrs
    catalogs = {}
    if "f32" in args.dtypes:
        catalogs["f32"] = e
    if "bf16" in args.dtypes:
        catalogs["bf16"] = e.astype(jnp.bfloat16)
    if "int8" in args.dtypes:
        catalogs["int8"] = jax.jit(quantize_index)(e)
    jax.block_until_ready(catalogs)
    if "f32" not in args.dtypes:
        del e
    lim = jnp.array([args.items, 1], jnp.int32)

    dev = jax.devices()[0]
    for name, cat in catalogs.items():
        rows, scales = (cat, None) if not isinstance(cat, tuple) else (
            cat.qvals, cat.scales[0])
        stage1 = {
            "kernel": jax.jit(lambda qq, ee, ss: groupmax_kernel(
                qq, ee, ss, lim, block_q=min(128, b))),
            "plain": jax.jit(lambda qq, ee, ss: groupmax_plain(
                qq, ee, ss, lim)),
        }
        for k in args.k:
            legs = {leg: jax.jit(lambda qq, cc, kern=(leg == "kernel"):
                                 catalog_topk(qq, cc, k, kernel=kern))
                    for leg in ("kernel", "plain")}
            for fn in legs.values():
                jax.block_until_ready(fn(q, cat))  # compile + warm
            times = {leg: [] for leg in legs}
            for r in range(args.rounds):
                order = ("kernel", "plain") if r % 2 == 0 else ("plain",
                                                                "kernel")
                for leg in order:
                    times[leg].append(_mean_ms(legs[leg], (q, cat),
                                               args.calls))
            s1 = {}
            if k == args.k[0]:
                for leg, fn in stage1.items():
                    jax.block_until_ready(fn(q, rows, scales))
                    s1[leg] = statistics.median(
                        _mean_ms(fn, (q, rows, scales), args.calls)
                        for _ in range(args.rounds))
            for leg in legs:
                ms = statistics.median(times[leg])
                out = {"dtype": name, "k": k, "leg": leg, "batch": b,
                       "items": args.items, "ms_per_call": ms,
                       "queries_per_sec": b / ms * 1e3,
                       "ms_rounds": times[leg],
                       "device": {"platform": dev.platform,
                                  "kind": dev.device_kind}}
                if leg in s1:
                    out["stage1_ms"] = s1[leg]
                print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
