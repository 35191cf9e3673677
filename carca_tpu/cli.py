"""Experiment driver CLI.

Flag names and defaults mirror the reference (``scripts/training.py:32-63``)
so existing invocations port directly, with fixes/additions:

* booleans parse strictly (``--residual_sa false`` works; the reference's
  ``type=bool`` treats any string as True);
* ``--device`` is accepted-and-ignored (JAX picks the backend: the GPU
  when present);
* added flags: ``--compute_dtype``, ``--mesh``, ``--preset``,
  ``--synthetic``, ``--resume``.

Compiled executables are cached across processes
(``utils/hostenv.enable_compilation_cache``: ``JAX_COMPILATION_CACHE_DIR``
when set, else ``<repo>/.jax_cache``).

Usage:
    python -m carca_tpu.cli --data_dir DATA --profile_file profiles.txt \
        --attr_file attrs.pkl --ctx_file ctx.pkl --out_dir results/run \
        --embedding all --decoder ca
"""

from __future__ import annotations

import argparse
from typing import Optional

from carca_tpu.config import (Config, DataConfig, ModelConfig, TrainConfig,
                              parse_bool, parse_tristate, preset)


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: prefix matching silently routed e.g. `--profile`
    # into `--profile_file`
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--profile_file", type=str, default="")
    p.add_argument("--attr_file", type=str, default="")
    p.add_argument("--ctx_file", type=str, default="")
    p.add_argument("--out_dir", type=str, default="results/run")

    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_schedule", type=str, default="none",
                   help="none | cosine | exponential")
    p.add_argument("--lr_decay_steps", type=int, default=0)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--debug_nans", type=parse_bool, default=False)
    p.add_argument("--profile", type=parse_bool, default=False,
                   help="capture a jax.profiler trace of the second epoch "
                        "into OUT_DIR/profile")
    p.add_argument("--seq_len", type=int, default=50)
    p.add_argument("--n_blocks", type=int, default=3)
    p.add_argument("--n_heads", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--l2_reg", type=float, default=0.0)
    p.add_argument("--d_dim", type=int, default=64)
    p.add_argument("--g_dim", type=int, default=256)
    p.add_argument("--residual_sa", type=parse_bool, default=True)
    p.add_argument("--residual_ca", type=parse_bool, default=True)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--early_stop", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--l2_norm", type=parse_bool, default=False)
    p.add_argument("--device", type=str, default="", help="ignored; JAX picks")
    p.add_argument("--test", type=parse_bool, default=True)
    p.add_argument("--n_workers", type=int, default=0, help="ignored; no workers needed")
    p.add_argument("--target_seq_len", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)

    p.add_argument("--encoding", type=str, default="identity")
    p.add_argument("--embedding", type=str, default="all")
    p.add_argument("--decoder", type=str, default="dot")
    p.add_argument("--model", type=str, default="carca",
                   help="carca (train) | knn (eval-only content baseline)")

    # additions
    p.add_argument("--preset", type=str, default="",
                   help="named BASELINE config: beauty|games|fashion|men|synthetic10m|smoke")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--remat", type=parse_bool, default=False)
    p.add_argument("--pack_tables", type=parse_tristate, default="auto",
                   help="lane-pack sub-128-wide embedding tables: true | "
                        "false | auto (never on the GPU)")
    p.add_argument("--synthetic", type=parse_bool, default=False)
    p.add_argument("--synthetic_users", type=int, default=2000)
    p.add_argument("--synthetic_items", type=int, default=1000)
    p.add_argument("--synthetic_process", default="zipf",
                   choices=("zipf", "markov"),
                   help="zipf = iid Zipf(1) items (v1; retrieval-saturated "
                        "per DESIGN 11c finding 9); markov = cluster-Markov "
                        "process with per-user preferences (v2 — retrieval "
                        "quality is falsifiable again)")
    p.add_argument("--resume", type=parse_bool, default=True)
    p.add_argument("--use_native", type=parse_bool, default=True)
    p.add_argument("--device_pipeline", type=parse_bool, default=False,
                   help="HBM-resident catalog + on-device batch assembly")
    p.add_argument("--inner_steps", type=int, default=8,
                   help="device-pipeline train/eval steps fused per dispatch "
                        "(lax.scan); 1 = one dispatch per step")
    p.add_argument("--mesh", type=str, default="",
                   help="multi-chip mesh shape, e.g. '8' (pure DP) or '4x2' "
                        "(data x model; row-sharded tables with "
                        "--shard_embeddings true)")
    p.add_argument("--shard_embeddings", type=parse_bool, default=False,
                   help="row-shard item/attr tables over the mesh 'model' axis")
    p.add_argument("--device_sampling", type=parse_bool, default=False,
                   help="sample train negatives on device (mesh path)")
    p.add_argument("--neg_distribution", type=str, default="uniform",
                   choices=("uniform", "popularity"),
                   help="train negatives (device pipeline): uniform = "
                        "reference protocol; popularity = empirical unigram")
    p.add_argument("--exact_rejection", type=parse_tristate, default="auto",
                   help="device-pipeline negative rejection: true = reject "
                        "vs the user's full history (reference protocol), "
                        "false = visible window only, auto = full history "
                        "when max history <= 4x seq_len")
    p.add_argument("--sparse_items_adam", type=parse_tristate,
                   default="auto",
                   help="lazy row-sparse Adam for the item table (device "
                        "pipeline, single chip): true | false | auto "
                        "(>=1M-item catalogs)")
    p.add_argument("--checkpoint", type=parse_bool, default=True,
                   help="false disables all checkpoint IO (benchmark runs)")
    p.add_argument("--checkpoint_interval", type=int, default=1,
                   help="refresh the latest/ full-state resume checkpoint "
                        "every N-th epoch (plus the first); best/ (params "
                        "only) always saves on improvement")
    p.add_argument("--loss", type=str, default="bce",
                   choices=("bce", "softmax"),
                   help="training objective: bce = the reference's 1-vs-K "
                        "masked BCE (src/train.py:86-93); softmax = "
                        "per-position sampled softmax over the candidate "
                        "groups (retrieval-aligned; logQ-corrected under "
                        "--neg_distribution popularity)")
    p.add_argument("--n_train_negatives", type=int, default=1,
                   help="negatives per positive train position (reference "
                        "protocol = 1; >1 requires --device_pipeline true)")
    p.add_argument("--eval_retrieval", type=int, default=0,
                   help="after training, run full-catalog leave-one-out "
                        "retrieval eval at this top-k (dot/wdot decoders)")
    p.add_argument("--eval_retrieval_every", type=int, default=0,
                   help="also run the retrieval eval (val split) every N-th "
                        "epoch DURING training and log retrieval_val_hr/ndcg "
                        "to metrics.jsonl (0 = off; dot/wdot decoders)")
    p.add_argument("--select_by", type=str, default="ndcg",
                   choices=("ndcg", "retrieval_hr", "retrieval_ndcg"),
                   help="best-checkpoint retention metric: ndcg = sampled "
                        "val NDCG (reference rule); retrieval_* = the "
                        "monitored full-catalog metric (needs "
                        "--eval_retrieval_every)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA (Polyak) weight averaging: 0 = off; d in "
                        "(0, 1) evaluates/retains/serves the shadow "
                        "d*shadow + (1-d)*params (drift mitigation, "
                        "DESIGN 11e finding 11)")
    p.add_argument("--retrieval_index", type=str, default="seen",
                   choices=("seen", "full"),
                   help="retrieval index: seen = items with >=1 training "
                        "event (production posture); full = whole id space")
    return p


# CLI flags that overlay a --preset Config when explicitly set: execution
# and tuning knobs, not model shape (a preset *is* the model shape).
_PRESET_OVERLAY = {
    "train": {
        "lr": "lr", "lr_schedule": "lr_schedule",
        "lr_decay_steps": "lr_decay_steps", "lr_decay_rate": "lr_decay_rate",
        "beta1": "beta1", "beta2": "beta2", "l2_reg": "l2_reg",
        "batch_size": "batch_size", "epochs": "epochs",
        "early_stop": "early_stop", "seed": "seed", "test": "test",
        "out_dir": "out_dir", "resume": "checkpoint_resume",
        "debug_nans": "debug_nans", "profile": "profile",
        "inner_steps": "inner_steps", "shard_embeddings": "shard_embeddings",
        "checkpoint_interval": "checkpoint_interval",
        "checkpoint": "checkpoint",
        "sparse_items_adam": "sparse_items_adam",
        "loss": "loss", "n_train_negatives": "n_train_negatives",
        "eval_retrieval_every": "eval_retrieval_every",
        "select_by": "select_by",
        "ema_decay": "ema_decay",
    },
    "data": {
        "use_native": "use_native", "device_pipeline": "device_pipeline",
        "synthetic_users": "synthetic_users",
        "synthetic_items": "synthetic_items",
        "synthetic_process": "synthetic_process",
        "device_sampling": "device_sampling",
        "exact_rejection": "exact_rejection",
        "neg_distribution": "neg_distribution",
        # the synthetic catalog must be reproducible from args.json alone
        # (carca-serve regenerates it at load time), so the run seed flows
        # into DataConfig.synthetic_seed too
        "seed": "synthetic_seed",
        "data_dir": "data_dir", "profile_file": "profile_file",
        "attr_file": "attr_file", "ctx_file": "ctx_file",
        "synthetic": "synthetic",
    },
    "model": {
        "compute_dtype": "compute_dtype",
        "remat": "remat", "dropout": "dropout", "l2_norm": "l2_norm",
        "gamma": "gamma", "pack_tables": "pack_tables",
        # plug-board ablations on top of a preset (e.g. the round-5
        # --embedding id-vs-all ablation at 10M); note the overlay only
        # fires when the flag differs from its parser default
        "embedding": "embedding", "encoding": "encoding",
        "decoder": "decoder",
    },
}


def parse_mesh(spec: str):
    """'8' → ((8,), ('data',)); '4x2' → ((4, 2), ('data', 'model'))."""
    if not spec:
        return (), ("data",)
    dims = tuple(int(d) for d in spec.lower().split("x"))
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh wants 'N' or 'NxM', got {spec!r}")
    return dims, ("data", "model")[: len(dims)]


def _overlay_cli_flags(cfg: Config, args) -> Config:
    """Apply CLI flags that differ from their parser defaults on top of a
    preset Config (a flag set to its default value is indistinguishable
    from an unset flag — that case keeps the preset's value)."""
    import dataclasses

    defaults = vars(build_parser().parse_args([]))
    sections = {"train": cfg.train, "data": cfg.data, "model": cfg.model}
    changed = {}
    for section, fields in _PRESET_OVERLAY.items():
        repl = {dst: getattr(args, src) for src, dst in fields.items()
                if getattr(args, src) != defaults[src]}
        if repl:
            changed[section] = dataclasses.replace(sections[section], **repl)
    if not changed:
        return cfg
    return Config(model=changed.get("model", cfg.model),
                  data=changed.get("data", cfg.data),
                  train=changed.get("train", cfg.train))


def config_from_args(args, n_items: int, n_attrs: int, n_ctx: int) -> Config:
    import dataclasses

    mesh_shape, mesh_axes = parse_mesh(args.mesh)
    if args.preset:
        cfg = _overlay_cli_flags(preset(args.preset, n_items, n_attrs, n_ctx),
                                 args)
        if mesh_shape:
            cfg = Config(model=cfg.model, data=cfg.data,
                         train=dataclasses.replace(
                             cfg.train, mesh_shape=mesh_shape,
                             mesh_axes=mesh_axes))
        return cfg
    mc = ModelConfig(
        n_items=n_items, n_attrs=n_attrs, n_ctx=n_ctx,
        d=args.d_dim, g=args.g_dim, seq_len=args.seq_len,
        target_len=args.target_seq_len, n_blocks=args.n_blocks,
        n_heads=args.n_heads, dropout=args.dropout,
        embedding=args.embedding.lower(), encoding=args.encoding.lower(),
        decoder=args.decoder.lower(), residual_sa=args.residual_sa,
        residual_ca=args.residual_ca, gamma=args.gamma, l2_norm=args.l2_norm,
        compute_dtype=args.compute_dtype, remat=args.remat,
        pack_tables=args.pack_tables,
    )
    dc = DataConfig(
        data_dir=args.data_dir, profile_file=args.profile_file,
        attr_file=args.attr_file, ctx_file=args.ctx_file,
        use_native=args.use_native, device_pipeline=args.device_pipeline,
        device_sampling=args.device_sampling,
        exact_rejection=args.exact_rejection,
        neg_distribution=args.neg_distribution,
        synthetic=args.synthetic,
        synthetic_users=args.synthetic_users,
        synthetic_items=args.synthetic_items,
        synthetic_seed=args.seed,
        synthetic_process=args.synthetic_process,
    )
    tc = TrainConfig(
        lr=args.lr, loss=args.loss,
        n_train_negatives=args.n_train_negatives,
        lr_schedule=args.lr_schedule,
        lr_decay_steps=args.lr_decay_steps, lr_decay_rate=args.lr_decay_rate,
        beta1=args.beta1, beta2=args.beta2, l2_reg=args.l2_reg,
        batch_size=args.batch_size, epochs=args.epochs,
        early_stop=args.early_stop, seed=args.seed, test=args.test,
        out_dir=args.out_dir, checkpoint_resume=args.resume,
        debug_nans=args.debug_nans, profile=args.profile,
        inner_steps=args.inner_steps,
        checkpoint=args.checkpoint,
        sparse_items_adam=args.sparse_items_adam,
        checkpoint_interval=args.checkpoint_interval,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        shard_embeddings=args.shard_embeddings,
        eval_retrieval_every=args.eval_retrieval_every,
        select_by=args.select_by,
        ema_decay=args.ema_decay,
    )
    return Config(model=mc, data=dc, train=tc)


def load_catalog(args, dc=None):
    """Load the catalog the *resolved* DataConfig describes (presets carry
    their own synthetic sizes; carca-serve must be able to regenerate the
    identical catalog from args.json)."""
    if dc is None:
        dc = config_from_args(args, 0, 0, 0).data
    if dc.synthetic or not dc.data_dir:
        from carca_tpu.data.synthetic import synthetic_generator
        # device_pipeline → generate the catalog in HBM too; the host
        # variant would ship O(GB) of attrs/ctx through the host→device
        # link first (see synthetic_catalog_device)
        gen = synthetic_generator(dc.synthetic_process,
                                  device=dc.device_pipeline)
        return gen(n_users=dc.synthetic_users,
                   n_real_items=dc.synthetic_items, seed=dc.synthetic_seed)
    from carca_tpu.data.loaders import load_dataset
    return load_dataset(dc.data_dir, dc.profile_file, dc.attr_file,
                        dc.ctx_file)


def main(argv: Optional[list] = None) -> None:
    from carca_tpu.utils.hostenv import enable_compilation_cache
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if args.mesh:
        # multi-process init must precede ANY JAX computation (including
        # the device-side synthetic catalog); no-op in a single process
        from carca_tpu.parallel.mesh import initialize_distributed
        initialize_distributed()
    catalog = load_catalog(args)
    cfg = config_from_args(args, catalog.n_items, catalog.n_attrs, catalog.n_ctx)

    if args.model.lower() == "knn":
        from carca_tpu.train.loop import evaluate_knn

        metrics = evaluate_knn(cfg, catalog)
    else:
        from carca_tpu.train.loop import evaluate_retrieval, fit

        state, metrics = fit(cfg, catalog)
        if args.eval_retrieval and cfg.model.decoder == "ca":
            print("note: --eval_retrieval applies to the dot/wdot decoders "
                  "(the cross-attention decoder is a ranking model, not a "
                  "retrieval tower); skipping retrieval eval")
        if args.eval_retrieval and cfg.model.decoder != "ca":
            params = state.params
            # drop the Adam moments (2x params — ~5 GB at 10M items)
            # before the catalog-embedding pass; training is over
            state = None
            metrics.update(evaluate_retrieval(
                cfg, catalog, params, k=args.eval_retrieval,
                seen_only=args.retrieval_index == "seen"))
    print("final:", metrics)


if __name__ == "__main__":
    main()
