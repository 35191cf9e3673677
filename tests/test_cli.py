"""CLI driver: flag parsing → Config mapping (SURVEY §2.1 #21), strict
booleans, presets, and KNN routing."""

import os
import subprocess
import sys

import numpy as np
import pytest

from carca_tpu.cli import build_parser, config_from_args, load_catalog
from carca_tpu.config import parse_bool, preset


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse(argv):
    return build_parser().parse_args(argv)


def _cpu_env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_ROOT)


def test_defaults_mirror_reference():
    """Reference CLI defaults (scripts/training.py:40-63)."""
    a = _parse([])
    assert (a.lr, a.seq_len, a.n_blocks, a.n_heads) == (0.001, 50, 3, 2)
    assert (a.dropout, a.d_dim, a.g_dim) == (0.5, 64, 256)
    assert (a.epochs, a.early_stop, a.batch_size) == (500, 20, 256)
    assert (a.beta1, a.beta2, a.gamma) == (0.9, 0.98, 0.9)
    assert (a.encoding, a.embedding, a.decoder) == ("identity", "all", "dot")
    assert a.target_seq_len == 100  # hard-coded in the reference (:153)


def test_strict_bool_fixes_reference_footgun():
    """`--residual_sa False` is truthy in the reference (type=bool);
    here it must parse as False."""
    a = _parse(["--residual_sa", "False", "--l2_norm", "true"])
    assert a.residual_sa is False and a.l2_norm is True
    with pytest.raises(ValueError):
        parse_bool("maybe")


def test_tristate_flag_parsing():
    from carca_tpu.config import parse_tristate

    assert parse_tristate("auto") == "auto"
    assert parse_tristate("true") is True and parse_tristate("0") is False
    with pytest.raises(ValueError):
        parse_tristate("maybe")
    assert _parse([]).pack_tables == "auto"
    with pytest.raises(SystemExit):  # the fused-attention flag is gone
        _parse(["--use_pallas", "true"])


def test_imports_without_flax_or_orbax():
    """Training, checkpointing and serving import with flax and orbax
    blocked (the GPU machine has neither)."""
    code = (
        "import sys\n"
        "for m in ('flax', 'flax.struct', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[m] = None\n"
        "import carca_tpu.train.loop, carca_tpu.train.checkpoint\n"
        "import carca_tpu.serve, carca_tpu.cli\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=_ROOT,
                         env=_cpu_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and the code sets nothing; unset, the
    cache is the fixed <repo>/.jax_cache."""
    import jax

    from carca_tpu.utils.hostenv import enable_compilation_cache

    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compilation_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(_ROOT, ".jax_cache")
            assert enable_compilation_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_config_mapping_roundtrip():
    a = _parse(["--d_dim", "32", "--decoder", "CA", "--embedding", "AttrCtx",
                "--pack_tables", "true", "--compute_dtype", "bfloat16",
                "--lr_schedule", "cosine", "--lr_decay_steps", "100"])
    cfg = config_from_args(a, n_items=50, n_attrs=4, n_ctx=2)
    assert cfg.model.d == 32
    assert cfg.model.decoder == "ca" and cfg.model.embedding == "attrctx"
    assert cfg.model.pack_tables is True
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.train.lr_schedule == "cosine"


def test_presets_cover_baseline_configs():
    for name in ("beauty", "games", "fashion", "men", "synthetic10m", "smoke"):
        cfg = preset(name, n_items=100, n_attrs=8, n_ctx=4)
        assert cfg.model.n_blocks >= 1
    assert preset("men", 100, 8, 4).model.seq_len == 200
    assert preset("synthetic10m").train.shard_embeddings
    with pytest.raises(ValueError):
        preset("nonsense")


def test_load_catalog_synthetic_path():
    a = _parse(["--synthetic", "true", "--synthetic_users", "50",
                "--synthetic_items", "40"])
    cat = load_catalog(a)
    assert cat.n_users == 50 and cat.n_items == 41  # + pad row
    assert np.all(cat.attrs[0] == 0)


def test_preset_overlays_explicit_cli_flags():
    """Execution/tuning flags set on the command line must override a
    --preset's values; unset flags keep the preset's (the old behavior
    silently discarded e.g. --inner_steps under --preset)."""
    from carca_tpu.cli import build_parser, config_from_args

    args = build_parser().parse_args(
        ["--preset", "beauty", "--inner_steps", "1", "--epochs", "3",
         "--batch_size", "32", "--compute_dtype", "bfloat16"])
    cfg = config_from_args(args, n_items=100, n_attrs=8, n_ctx=4)
    assert cfg.train.inner_steps == 1
    assert cfg.train.epochs == 3
    assert cfg.train.batch_size == 32
    assert cfg.model.compute_dtype == "bfloat16"
    # model *shape* comes from the preset, untouched by parser defaults
    base = preset("beauty", 100, 8, 4)
    assert cfg.model.seq_len == base.model.seq_len
    assert cfg.model.d == base.model.d

    # no explicit flags → preset passes through unchanged
    args = build_parser().parse_args(["--preset", "beauty"])
    assert config_from_args(args, 100, 8, 4) == base


def test_mesh_flag_parsing():
    from carca_tpu.cli import parse_mesh

    assert parse_mesh("") == ((), ("data",))
    assert parse_mesh("8") == ((8,), ("data",))
    assert parse_mesh("4x2") == ((4, 2), ("data", "model"))
    with pytest.raises(ValueError):
        parse_mesh("2x2x2")

    a = _parse(["--mesh", "4x2", "--shard_embeddings", "true",
                "--synthetic", "true"])
    cfg = config_from_args(a, 100, 8, 4)
    assert cfg.train.mesh_shape == (4, 2)
    assert cfg.train.mesh_axes == ("data", "model")
    assert cfg.train.shard_embeddings is True

    # mesh overlays presets too
    a = _parse(["--preset", "beauty", "--mesh", "8"])
    cfg = config_from_args(a, 100, 8, 4)
    assert cfg.train.mesh_shape == (8,)
    assert cfg.model.d == 64  # preset shape untouched


def test_catalog_reproducible_from_resolved_data_config():
    """The serving loop regenerates the catalog from args.json, so the run
    seed must flow into DataConfig.synthetic_seed and load_catalog must
    honor the *resolved* (preset-aware) data config."""
    a = _parse(["--synthetic", "true", "--seed", "5",
                "--synthetic_users", "30", "--synthetic_items", "25"])
    cfg = config_from_args(a, 0, 0, 0)
    assert cfg.data.synthetic_seed == 5
    cat1 = load_catalog(a)
    from carca_tpu.data.synthetic import synthetic_catalog
    cat2 = synthetic_catalog(n_users=30, n_real_items=25, seed=5)
    np.testing.assert_array_equal(cat1.items, cat2.items)
    np.testing.assert_array_equal(cat1.attrs, cat2.attrs)

    # presets carry their own synthetic sizes; load_catalog must use them
    a = _parse(["--preset", "smoke"])
    cat = load_catalog(a)
    assert cat.n_users == 200 and cat.n_items == 101

    # the at-scale preset must not trip fit()'s device_pipeline/mesh guard
    cfg = preset("synthetic10m")
    assert not (cfg.data.device_pipeline and cfg.train.mesh_shape)


def test_cli_end_to_end_reference_file_formats(tmp_path):
    """The full reference workflow through the CLI: write a catalog in the
    reference's on-disk formats (profiles.txt / attrs.pkl / ctx.pkl,
    src/data.py:17-50), train via --data_dir with the reference's flag
    names, and check the reference's output contract (CSV log, args.json,
    checkpoints, final metrics)."""
    import json
    import os

    from carca_tpu.cli import main
    from carca_tpu.data.synthetic import (synthetic_catalog,
                                          write_reference_format)

    cat = synthetic_catalog(n_users=120, n_real_items=80, seed=3)
    data_dir = str(tmp_path / "data")
    out_dir = str(tmp_path / "run")
    write_reference_format(cat, data_dir)

    main(["--data_dir", data_dir,
          "--profile_file", "profiles.txt",
          "--attr_file", "attrs.pkl",
          "--ctx_file", "ctx.pkl",
          "--seq_len", "8", "--target_seq_len", "12",
          "--d_dim", "16", "--g_dim", "32", "--n_blocks", "1",
          "--batch_size", "16", "--epochs", "2", "--early_stop", "5",
          "--embedding", "all", "--decoder", "ca", "--dropout", "0.0",
          "--resume", "false", "--out_dir", out_dir])

    args = json.load(open(os.path.join(out_dir, "args.json")))
    assert args["seq_len"] == 8 and args["decoder"] == "ca"
    csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    assert csvs, "reference CSV log contract missing"
    rows = open(os.path.join(out_dir, csvs[0])).read().strip().splitlines()
    # time;epoch;split;loss;HR;NDCG rows for train/val/test
    assert any(";val;" in r for r in rows)
    assert any(";test;" in r for r in rows)
    assert os.path.isdir(os.path.join(out_dir, "ckpt", "best"))
