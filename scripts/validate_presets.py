"""Convergence-parity validation across the BASELINE.json config families.

The five target configs (BASELINE.json ``configs``) differ in shape, not
protocol: Games adds wider context features at d=128, Fashion fuses dense
image-like attribute vectors through ``attrctx``, Men stresses long
sequences (L=200). This script trains **both** implementations on the same
family-shaped deterministic synthetic dataset (written in the reference's
own file formats for its side) and reports best-val / test HR@10, NDCG@10
side by side.

Usage:
    python scripts/validate_presets.py games [--epochs 25] [--skip_reference]
    python scripts/validate_presets.py all --epochs 25

Results land in VALIDATION_<family>.json at the repo root; the reference
side reuses scripts/measure_reference.py (torch CPU, read-only) and ours
runs on whatever accelerator JAX exposes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# family-shaped synthetic datasets: same catalog knobs feed both sides
FAMILIES = {
    # configs[1]: contextual (time) features, d=128
    "games": dict(users=4096, items=2000, d_dim=128, g_dim=256, seq_len=50,
                  n_attrs=12, n_ctx=8, min_len=4, max_len=30,
                  embedding="all", decoder="ca"),
    # configs[2]: dense image-attribute vectors fused via attrctx
    "fashion": dict(users=4096, items=2000, d_dim=128, g_dim=512, seq_len=50,
                    n_attrs=128, n_ctx=4, min_len=4, max_len=30,
                    embedding="attrctx", decoder="ca"),
    # configs[3]: long sequences stressing the cross-attention scorer
    "men": dict(users=2048, items=2000, d_dim=64, g_dim=256, seq_len=200,
                n_attrs=12, n_ctx=4, min_len=40, max_len=250,
                embedding="all", decoder="ca"),
}


def run_ours(fam: dict, epochs: int, early_stop: int, out_dir: str) -> dict:
    from carca_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from carca_tpu.data.synthetic import canonicalize_repeat_ctx, synthetic_catalog
    from carca_tpu.train.loop import fit

    cat = synthetic_catalog(
        n_users=fam["users"], n_real_items=fam["items"],
        n_attrs=fam["n_attrs"], n_ctx=fam["n_ctx"],
        min_len=fam["min_len"], max_len=fam["max_len"], seed=0)
    # the reference reads ctx from a (user,item)-keyed dict — mirror that
    cat = canonicalize_repeat_ctx(cat)
    mc = ModelConfig(
        n_items=cat.n_items, n_attrs=cat.n_attrs, n_ctx=cat.n_ctx,
        d=fam["d_dim"], g=fam["g_dim"], seq_len=fam["seq_len"],
        target_len=100, n_blocks=2, n_heads=2, dropout=0.5,
        embedding=fam["embedding"], encoding="identity",
        decoder=fam["decoder"])
    cfg = Config(
        model=mc,
        data=DataConfig(synthetic=True),
        train=TrainConfig(batch_size=256, epochs=epochs,
                          early_stop=early_stop, seed=0, out_dir=out_dir,
                          checkpoint_resume=True))
    _, metrics = fit(cfg, cat)
    return metrics


def run_reference(fam: dict, epochs: int, early_stop: int, out: str) -> dict:
    cmd = [sys.executable, os.path.join(REPO, "scripts/measure_reference.py"),
           "--epochs", str(epochs), "--early_stop", str(early_stop),
           "--out", out]
    for flag in ("users", "items", "d_dim", "g_dim", "seq_len", "n_attrs",
                 "n_ctx", "min_len", "max_len", "embedding", "decoder"):
        cmd += [f"--{flag}", str(fam[flag])]
    subprocess.run(cmd, check=True, timeout=4 * 3600)
    with open(out) as fh:
        return json.load(fh)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=[*FAMILIES, "all"])
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--early_stop", type=int, default=8)
    ap.add_argument("--skip_reference", action="store_true")
    ap.add_argument("--skip_ours", action="store_true")
    args = ap.parse_args()

    names = list(FAMILIES) if args.family == "all" else [args.family]
    for name in names:
        fam = FAMILIES[name]
        path = os.path.join(REPO, f"VALIDATION_{name}.json")
        result = {}
        if os.path.exists(path):
            with open(path) as fh:
                result.update(json.load(fh))
        # the CURRENT family definition wins over whatever an older file
        # recorded — fresh metrics must never be paired with stale config
        result["family"] = name
        result["config"] = fam
        if not args.skip_ours:
            ours = run_ours(fam, args.epochs, args.early_stop,
                            os.path.join(REPO, f"results/validate_{name}"))
            result["carca_tpu"] = ours
        if not args.skip_reference:
            ref = run_reference(fam, args.epochs, args.early_stop,
                                os.path.join(REPO, f"VALIDATION_{name}_ref.json"))
            result["reference"] = ref
        with open(path, "w") as fh:
            json.dump(result, fh, indent=2)
        print(json.dumps(result.get("carca_tpu", {}), indent=None))
        ours, ref = result.get("carca_tpu"), result.get("reference")
        if ours and ref:
            print(f"[{name}] test HR@10 ours={ours.get('test_hr'):.4f} "
                  f"ref={ref.get('test_hr10')} | test NDCG@10 "
                  f"ours={ours.get('test_ndcg'):.4f} "
                  f"ref={ref.get('test_ndcg10')}")


if __name__ == "__main__":
    main()
