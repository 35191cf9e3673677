"""Measure the PyTorch reference's baseline numbers (throughput + metrics).

The reference publishes no benchmarks (SURVEY.md §6 / BASELINE.md), so the
parity/throughput target is *measured* by running the reference itself —
read-only, via its own CLI — on the same deterministic synthetic dataset
this framework benches on, then recorded in BASELINE_MEASURED.json for
``bench.py``'s ``vs_baseline``.

Usage:
    python scripts/measure_reference.py [--epochs 3] [--out BASELINE_MEASURED.json]

Runs on CPU torch (no CUDA in this image). Throughput is parsed from the
epoch wall-clock of the reference's own log lines; HR/NDCG from its val
evaluations.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--early_stop", type=int, default=20)
    ap.add_argument("--users", type=int, default=4096)
    ap.add_argument("--items", type=int, default=2000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--decoder", type=str, default="ca")
    ap.add_argument("--embedding", type=str, default="all")
    ap.add_argument("--d_dim", type=int, default=64)
    ap.add_argument("--g_dim", type=int, default=256)
    ap.add_argument("--seq_len", type=int, default=50)
    ap.add_argument("--n_attrs", type=int, default=12)
    ap.add_argument("--n_ctx", type=int, default=4)
    ap.add_argument("--max_len", type=int, default=30)
    ap.add_argument("--min_len", type=int, default=4)
    ap.add_argument("--out", type=str,
                    default=os.path.join(REPO, "BASELINE_MEASURED.json"))
    args = ap.parse_args()
    default_out = os.path.join(REPO, "BASELINE_MEASURED.json")
    flagship = ((args.decoder, args.embedding, args.d_dim, args.g_dim,
                 args.seq_len, args.users, args.items, args.batch_size,
                 args.max_len, args.min_len)
                == ("ca", "all", 64, 256, 50, 4096, 2000, 256, 30, 4)
                and args.epochs >= 3)
    if args.out == default_out and not flagship:
        raise SystemExit(
            "BASELINE_MEASURED.json is the flagship baseline bench.py "
            "compares against; it may only be overwritten by the exact "
            "flagship workload (ca/all d=64 g=256 L=50, 4096x2000, batch "
            "256, >=3 epochs) — pass --out for other configs")

    sys.path.insert(0, REPO)
    from carca_tpu.data.synthetic import synthetic_catalog, write_reference_format

    cat = synthetic_catalog(n_users=args.users, n_real_items=args.items,
                            n_attrs=args.n_attrs, n_ctx=args.n_ctx,
                            min_len=args.min_len, max_len=args.max_len, seed=0)
    data_dir = tempfile.mkdtemp(prefix="carca_ref_data_")
    write_reference_format(cat, data_dir)
    out_dir = tempfile.mkdtemp(prefix="carca_ref_out_")

    n_train_users = cat.n_users  # all synthetic users have ≥4 events

    cmd = [
        sys.executable, "scripts/training.py",
        "--data_dir", data_dir,
        "--profile_file", "profiles.txt",
        "--attr_file", "attrs.pkl",
        "--ctx_file", "ctx.pkl",
        "--out_dir", out_dir,
        "--device", "cpu",
        "--epochs", str(args.epochs),
        "--early_stop", str(args.early_stop),
        "--n_blocks", "2",
        "--d_dim", str(args.d_dim),
        "--g_dim", str(args.g_dim),
        "--seq_len", str(args.seq_len),
        "--batch_size", str(args.batch_size),
        "--decoder", args.decoder,
        "--embedding", args.embedding,
        "--encoding", "identity",
        "--n_workers", "2",
    ]
    env = dict(os.environ, PYTHONPATH=REFERENCE,  # `from src...` imports
               # reference uses whole-module torch.save/load (src/train.py:
               # 117-142); torch>=2.6 defaults weights_only=True and refuses
               TORCH_FORCE_NO_WEIGHTS_ONLY_LOAD="1")
    t0 = time.time()
    proc = subprocess.run(
        cmd, cwd=REFERENCE, capture_output=True, text=True, timeout=7200,
        env=env)
    wall = time.time() - t0
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"reference run failed rc={proc.returncode}")

    # reference log lines: "HH:MM:SS - Epoch NNN: Train Loss = X"
    #                      "HH:MM:SS - Epoch NNN: Val Loss = X HR = h, NDCG = n"
    stamps = re.findall(
        r"(\d+):(\d+):(\d+) - Epoch (\d+): (Train|Val|Test) Loss = ([\d.]+)"
        r"(?:\s+HR = ([\d.]+), NDCG = ([\d.]+))?",
        proc.stdout)
    if not stamps:
        raise SystemExit("could not parse reference log:\n" + proc.stdout[-2000:])

    def secs(h, m, s):
        return int(h) * 3600 + int(m) * 60 + int(s)

    # per-epoch train time = gap between successive Val and Train stamps
    train_times = []
    hr = ndcg = best_ndcg = best_hr = test_hr = test_ndcg = None
    prev_val_t = None
    for h, m, s, ep, split, loss, h10, n10 in stamps:
        t = secs(h, m, s)
        if split == "Train":
            if prev_val_t is not None:
                train_times.append((t - prev_val_t) % 86400)
        elif split == "Val":
            prev_val_t = t
            hr, ndcg = float(h10), float(n10)
            if best_ndcg is None or ndcg > best_ndcg:
                best_ndcg, best_hr = ndcg, hr
        elif split == "Test" and h10:
            test_hr, test_ndcg = float(h10), float(n10)
    # first epoch: from process start — approximate with wall/epochs if only
    # one epoch; steady-state = later epochs when available
    if train_times:
        epoch_s = sum(train_times) / len(train_times)
        examples_per_sec = n_train_users / max(epoch_s, 1e-9)
    else:
        # a 1-epoch run has no isolated train-epoch timing; wall/epochs
        # would fold imports + data build + eval + checkpointing into the
        # "throughput" and deflate the baseline
        epoch_s = wall / max(args.epochs, 1)
        examples_per_sec = None

    result = {
        "source": "r-papso/carca-replication scripts/training.py (torch CPU)",
        "config": {
            "users": args.users, "items": args.items, "d": args.d_dim,
            "g": args.g_dim, "n_blocks": 2, "seq_len": args.seq_len,
            "n_attrs": args.n_attrs, "n_ctx": args.n_ctx,
            "max_len": args.max_len, "batch_size": args.batch_size,
            "decoder": args.decoder, "embedding": args.embedding,
            "epochs": args.epochs, "early_stop": args.early_stop,
        },
        "train_examples_per_sec": round(examples_per_sec, 2),
        "epoch_seconds": round(epoch_s, 2),
        "val_hr10": hr,
        "val_ndcg10": ndcg,
        "best_val_hr10": best_hr,
        "best_val_ndcg10": best_ndcg,
        "test_hr10": test_hr,
        "test_ndcg10": test_ndcg,
        "wall_seconds": round(wall, 1),
    }
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
