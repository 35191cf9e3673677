"""Typed configuration for models, data, and training.

Replaces the reference's argparse-only flag system (``scripts/training.py:32-63``)
with frozen dataclasses, named presets for the five BASELINE.json configs, and an
``args.json``-compatible dump (``scripts/training.py:108-110``). Fixes the
reference's ``type=bool`` argparse footgun (``scripts/training.py:48-49,56,58`` —
any string parsed as True) by parsing booleans strictly.

Defaults mirror the reference CLI defaults (``scripts/training.py:40-63``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

EMBEDDINGS = ("all", "attrctx", "attr", "id", "mlpid")
ENCODINGS = ("identity", "learnable", "positional")
DECODERS = ("ca", "dot", "wdot")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    Shapes/dimensions follow the reference CLI (``scripts/training.py:40-63``):
    ``d`` is the model width (``--d_dim``), ``g`` the feature-fusion hidden
    width (``--g_dim``).

    ``n_items`` counts the pad row: item id 0 is the universal pad
    (``src/data.py:28-35`` prepends a zero attribute row; ``src/utils.py:6-7``
    treats id 0 as masked everywhere).
    """

    n_items: int
    n_attrs: int
    n_ctx: int
    d: int = 64
    g: int = 256
    seq_len: int = 50
    target_len: int = 100  # eval candidates = target_len + 1 (src/data.py:153)
    n_blocks: int = 3
    n_heads: int = 2
    dropout: float = 0.5
    embedding: str = "all"  # one of EMBEDDINGS
    encoding: str = "identity"  # one of ENCODINGS
    decoder: str = "dot"  # one of DECODERS
    residual_sa: bool = True
    residual_ca: bool = True
    gamma: float = 0.9  # WeightedDotProduct decay (src/carca.py:373)
    l2_norm: bool = False  # WeightedDotProduct cosine mode (src/carca.py:381-391)
    # --- execution knobs (no reference counterpart) ---
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core matmuls
    remat: bool = False  # jax.checkpoint the encoder stack (HBM for FLOPs)
    # Lane-pack sub-128-wide embedding tables ([n, d] → [⌈n/p⌉, p·d],
    # p = 128/d): True | False | "auto" (never packs: the GPU stores
    # narrow rows densely). See ops/packed_table.py.
    pack_tables: Any = "auto"

    def __post_init__(self) -> None:
        if self.embedding not in EMBEDDINGS:
            raise ValueError(f"unknown embedding {self.embedding!r}; want one of {EMBEDDINGS}")
        if self.encoding not in ENCODINGS:
            raise ValueError(f"unknown encoding {self.encoding!r}; want one of {ENCODINGS}")
        if self.decoder not in DECODERS:
            raise ValueError(f"unknown decoder {self.decoder!r}; want one of {DECODERS}")
        if self.d % self.n_heads != 0:
            raise ValueError("d must be divisible by n_heads (src/carca.py:208)")
        if self.pack_tables not in (True, False, "auto"):
            raise ValueError(
                f"pack_tables must be True, False, or 'auto'; got {self.pack_tables!r}")

    @property
    def head_dim(self) -> int:
        return self.d // self.n_heads


@dataclass(frozen=True)
class DataConfig:
    """Dataset location and host-pipeline knobs.

    File formats follow the reference loaders: ``profile_file`` is a text file
    of ``"user_id item_id"`` lines in temporal order (``src/data.py:38-50``),
    ``attr_file`` a pickled ``[n_items, n_attrs]`` float array
    (``src/data.py:28-35``), ``ctx_file`` a pickled ``{(user, item): vec}``
    dict (``src/data.py:17-25``).
    """

    data_dir: str = ""
    profile_file: str = ""
    attr_file: str = ""
    ctx_file: str = ""
    eval_subsample: int = 10_000  # val/test user cap (scripts/training.py:154-157)
    use_native: bool = True  # C++ batch assembler when built; numpy fallback
    # device-resident catalog + on-device batch assembly: per-step H2D is a
    # [B] user-row vector instead of ~1 MB of tensors. Negative rejection
    # then uses the visible window (see device_sampling note below).
    device_pipeline: bool = False
    # on-device negative sampling (mesh host-pipeline path)
    device_sampling: bool = False
    # device-pipeline negative rejection set: True → the user's FULL
    # history (the reference's exact protocol, src/data.py:77-87), False →
    # visible window + targets only, "auto" → full history when the
    # dataset's max history length is ≤ 4× seq_len (the all-pairs compare
    # cost is linear in the reject-set width)
    exact_rejection: Any = "auto"
    # TRAIN negative distribution (device pipeline): "uniform" is the
    # reference protocol (src/data.py:82); "popularity" draws from the
    # empirical unigram distribution (a uniform random event's item) —
    # standard practice for full-catalog retrieval training
    # (docs/DESIGN.md #11). Eval negatives are always uniform (protocol).
    neg_distribution: str = "uniform"
    synthetic: bool = False  # deterministic synthetic dataset (tests/bench)
    synthetic_users: int = 2000
    synthetic_items: int = 1000
    synthetic_seed: int = 0
    # "zipf" = iid Zipf(1) items (v1; saturated per DESIGN §11c finding 9:
    # popularity ranking is Bayes-optimal, so it can no longer falsify a
    # retrieval-quality claim); "markov" = cluster-Markov process with
    # per-user preferences (v2 — Bayes-optimal retrieval must read the
    # history; data/synthetic.py module docstring)
    synthetic_process: str = "zipf"


@dataclass(frozen=True)
class TrainConfig:
    """Optimization & loop hyperparameters (reference defaults,
    ``scripts/training.py:40-59``)."""

    lr: float = 1e-3
    # --- training objective (TPU-native additions; the reference is
    # hard-wired to 1-vs-1 masked BCE, src/train.py:86-93) ---
    # "bce" = the reference loss. "softmax" = per-position sampled softmax
    # over [positive, n_train_negatives negatives] — the retrieval-aligned
    # objective (full-catalog ranking is a softmax over N, and a sampled
    # softmax is its unbiased surrogate; 1-vs-1 BCE is the weakest
    # possible retrieval signal — see docs/DESIGN.md §11c).
    loss: str = "bce"
    # K uniform (or popularity) negatives per positive train position.
    # 1 = the reference protocol; >1 needs the device pipeline (negatives
    # are drawn on device). Eval protocol is unaffected.
    n_train_negatives: int = 1
    # optional LR schedule (the reference's train() accepts a torch
    # scheduler, src/train.py:68,110-111, though its CLI never passes one)
    lr_schedule: str = "none"  # none | cosine | exponential
    lr_decay_steps: int = 0  # horizon in steps (0 → disabled)
    lr_decay_rate: float = 0.1  # exponential: rate per horizon; cosine: alpha
    beta1: float = 0.9
    beta2: float = 0.98
    l2_reg: float = 0.0  # torch Adam weight_decay semantics (grad += wd * p)
    batch_size: int = 256
    epochs: int = 500
    early_stop: int = 20
    top_k: int = 10
    seed: int = 0
    verbose: int = 1
    test: bool = True  # leave-one-out mode flag (src/data.py:59-72)
    out_dir: str = "results/run"
    # --- TPU-native knobs ---
    mesh_shape: Tuple[int, ...] = ()  # () = single device; e.g. (8,) or (4, 2)
    mesh_axes: Tuple[str, ...] = ("data",)  # e.g. ("data", "model")
    shard_embeddings: bool = False  # row-shard item/attr tables over 'model'
    # device-pipeline only: train steps fused into one dispatch via lax.scan
    # (amortizes per-dispatch host overhead; 1 = one dispatch per step)
    inner_steps: int = 8
    profile: bool = False  # jax.profiler trace annotations
    debug_nans: bool = False  # jax_debug_nans (SURVEY §5 race/NaN checks)
    checkpoint_resume: bool = True
    # master switch: False disables all checkpoint writes/reads (benchmark
    # runs — a best-save is ~1 GB of IO at the 10M-item scale); the final
    # test eval then uses the live end-of-training state
    checkpoint: bool = True
    # refresh the latest/ full-state resume checkpoint every N-th epoch
    # (plus the first epoch of a run); best/ (params only) still saves on
    # every improvement. >1 trades resume granularity for IO at large
    # state sizes (the 10M-item full state is ~5 GB/save)
    checkpoint_interval: int = 1
    # lazy (row-sparse) Adam for the item-embedding table on the device-
    # pipeline path: True | False | "auto" (on for >=1M-item catalogs,
    # single-chip). Removes the dense table+moments HBM sweep from every
    # step (~13 GB at 10M items); untouched rows skip moment decay — the
    # standard LazyAdam/SparseAdam trade. See train/sparse_adam.py.
    sparse_items_adam: Any = "auto"
    # run full-catalog retrieval eval (val split, seen-items index) every
    # N-th epoch during fit and log retrieval_val_hr/ndcg to metrics.jsonl.
    # 0 = off. Dot-family decoders only; the sampled val eval is blind to
    # the retrieval regime at extreme sparsity (docs/DESIGN.md §11), so
    # retrieval deployments should monitor this curve directly.
    eval_retrieval_every: int = 0
    # best-checkpoint selection metric: "ndcg" = sampled val NDCG@k (the
    # reference's retention rule, src/train.py:114-124); "retrieval_hr" /
    # "retrieval_ndcg" = the monitored full-catalog metric — requires
    # eval_retrieval_every >= 1 and a dot-family decoder. At extreme
    # sparsity the two disagree violently (retrieval peaks epochs before
    # sampled NDCG — DESIGN §11), so retrieval deployments should select
    # on what they serve. With eval_retrieval_every > 1 the improvement /
    # early-stop decision only advances on monitored epochs; scale
    # early_stop accordingly.
    select_by: str = "ndcg"
    # exponential moving average of the weights (Polyak averaging):
    # 0.0 = off; d in (0, 1) keeps shadow = d*shadow + (1-d)*params after
    # every optimizer step (seeded from the live weights, no bias
    # correction), and ALL evaluation — sampled val, retrieval monitoring,
    # best-checkpoint retention, final test — runs on the shadow. The
    # retained best/ checkpoint therefore holds the EMA weights (what a
    # deployment serves). Rationale: retrieval-objective runs collapse
    # one-three epochs past their peak (DESIGN §11e finding 11: 0.0710 →
    # 0.0012 by ep10), so retention must catch a fleeting per-epoch peak;
    # an EMA both smooths the serve-quality curve between epoch
    # boundaries and de-noises the peak itself. Costs one extra params
    # copy in HBM plus a tree-map per step (with inner_steps > 1 the
    # shadow updates once per fused dispatch with decay d**inner_steps —
    # the K intermediate states never materialize off-device).
    ema_decay: float = 0.0


@dataclass(frozen=True)
class Config:
    model: ModelConfig
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def dump_args_json(self, path: str) -> None:
        """Write the flat args.json contract (``scripts/training.py:108-110``)."""
        flat: Dict[str, Any] = {}
        for section in (self.model, self.data, self.train):
            for f in dataclasses.fields(section):
                flat[f.name] = getattr(section, f.name)
        with open(path, "w") as fh:
            fh.write(json.dumps(flat, default=str))


def _beauty_like(n_items: int, n_attrs: int, n_ctx: int, **model_kw: Any) -> ModelConfig:
    return ModelConfig(n_items=n_items, n_attrs=n_attrs, n_ctx=n_ctx, **model_kw)


def preset(name: str, n_items: int = 0, n_attrs: int = 0, n_ctx: int = 0) -> Config:
    """Named presets for the five BASELINE.json configs.

    Catalog dimensions (``n_items``/``n_attrs``/``n_ctx``) are dataset
    properties; pass them in when known, otherwise the loader fills them.
    """
    if name == "beauty":  # configs[0]: 2-block d=64, seq 50, 100-neg eval
        m = _beauty_like(n_items, n_attrs, n_ctx, d=64, n_blocks=2, seq_len=50,
                         embedding="all", decoder="ca", encoding="identity")
        return Config(model=m)
    if name == "games":  # configs[1]: contextual time features, d=128
        m = _beauty_like(n_items, n_attrs, n_ctx, d=128, n_blocks=2, seq_len=50,
                         embedding="all", decoder="ca")
        return Config(model=m)
    if name == "fashion":  # configs[2]: dense image-attribute vectors
        m = _beauty_like(n_items, n_attrs, n_ctx, d=128, g=512, n_blocks=2,
                         seq_len=50, embedding="attrctx", decoder="ca")
        return Config(model=m)
    if name == "men":  # configs[3]: long sequences (len 200)
        m = _beauty_like(n_items, n_attrs, n_ctx, d=64, n_blocks=2, seq_len=200,
                         embedding="all", decoder="ca")
        return Config(model=m)
    if name == "synthetic10m":  # configs[4]: sharded tables, full-catalog scoring
        # d=64: the 10M-row table + its Adam moments are 3 x 2.56 GB in
        # f32, ~10 GB with attrs and activations — one card's memory holds
        # it with room to spare
        m = _beauty_like(n_items or 10_000_001, n_attrs or 64, n_ctx or 8,
                         d=64, n_blocks=2, seq_len=50, embedding="all",
                         decoder="dot", compute_dtype="bfloat16")
        # single-chip runnable as-is (HBM-resident catalog + on-device
        # sampling). On a pod slice, add `--mesh NxM` — the device
        # pipeline composes with the mesh (catalog replicated, user rows
        # sharded over 'data', tables row-sharded via shard_embeddings).
        return Config(
            model=m,
            data=DataConfig(synthetic=True, synthetic_users=100_000,
                            synthetic_items=10_000_000,
                            device_sampling=True, device_pipeline=True),
            train=TrainConfig(shard_embeddings=True,
                              mesh_axes=("data", "model"),
                              # full-state resume snapshots are ~5 GB at
                              # this scale; refresh every 10 epochs
                              checkpoint_interval=10),
        )
    if name == "smoke":  # tiny deterministic CPU config for tests
        m = _beauty_like(n_items or 101, n_attrs or 12, n_ctx or 4, d=16, g=32,
                         n_blocks=2, n_heads=2, seq_len=10, target_len=20,
                         dropout=0.1, decoder="ca")
        return Config(
            model=m,
            data=DataConfig(synthetic=True, synthetic_users=200, synthetic_items=100),
            train=TrainConfig(batch_size=32, epochs=5, early_stop=3),
        )
    raise ValueError(f"unknown preset {name!r}")


def parse_bool(s: Any) -> bool:
    """Strict boolean parsing — fixes the reference's ``type=bool`` footgun
    where ``--residual_sa False`` parsed as True (``scripts/training.py:48``)."""
    if isinstance(s, bool):
        return s
    v = str(s).strip().lower()
    if v in ("1", "true", "t", "yes", "y"):
        return True
    if v in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean from {s!r}")


def parse_tristate(s: Any) -> Any:
    """Parse a tri-state flag: strict boolean or the string "auto"."""
    if str(s).strip().lower() == "auto":
        return "auto"
    return parse_bool(s)
