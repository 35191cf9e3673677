"""Analytic FLOP accounting (utils/flops.py) — hand-computed oracle."""

import pytest

from carca_tpu.config import ModelConfig
from carca_tpu.utils.flops import (device_peak_flops, device_peak_hbm_bps,
                                   forward_flops_per_example,
                                   train_step_flops, train_step_hbm_bytes)


def test_forward_flops_ca_hand_computed():
    # tiny config, every term written out independently
    mc = ModelConfig(n_items=100, n_attrs=3, n_ctx=2, d=8, g=4, seq_len=5,
                     target_len=10, n_blocks=2, n_heads=2,
                     embedding="all", decoder="ca")
    L, T, d, g, a, c = 5, 10, 8, 4, 3, 2
    embed = (L + T) * (2 * (a + c) * g + 2 * (g + d) * d)
    enc = 2 * (3 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * d)
    dec = 2 * T * d * d + 2 * 2 * L * d * d + 2 * 2 * T * L * d + 2 * T * d
    assert forward_flops_per_example(mc, T) == embed + enc + dec


def test_train_is_three_forwards_at_2L_targets():
    mc = ModelConfig(n_items=100, n_attrs=3, n_ctx=2, d=8, seq_len=5,
                     n_blocks=1, n_heads=2, decoder="dot")
    f = forward_flops_per_example(mc, 2 * mc.seq_len)
    assert train_step_flops(mc, batch_size=7) == 3 * 7 * f


def test_decoder_and_embedding_variants_ordered():
    base = dict(n_items=100, n_attrs=3, n_ctx=2, d=8, seq_len=5, n_blocks=1,
                n_heads=2)
    f = {dec: forward_flops_per_example(
            ModelConfig(decoder=dec, **base), 10)
         for dec in ("ca", "wdot", "dot")}
    assert f["ca"] > f["wdot"] > f["dot"] > 0
    e = {emb: forward_flops_per_example(
            ModelConfig(embedding=emb, **base), 10)
         for emb in ("all", "attrctx", "attr", "mlpid", "id")}
    assert e["all"] > e["attrctx"] > e["attr"] > e["mlpid"] > e["id"]
    # "id" has no fusion matmuls: only encoder + dot decoder remain
    L, d = base["seq_len"], base["d"]
    enc = 3 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * d
    assert e["id"] == enc + 2 * 10 * d


def test_hbm_bytes_model():
    mc = ModelConfig(n_items=1_000_001, n_attrs=12, n_ctx=4, d=64, g=256,
                     seq_len=50, n_blocks=2, n_heads=2, decoder="dot")
    dense = train_step_hbm_bytes(mc, 256)
    sparse = train_step_hbm_bytes(mc, 256, sparse_items=True)
    # dense Adam streams the whole 1M-row table 8x; lazy sparse Adam
    # touches at most the batch's token rows — the dominant term at
    # catalog scale, so the gap must be the 8-pass table stream
    table_stream = 8.0 * mc.n_items * mc.d * 4
    touched = 8.0 * min(256 * 3 * 50, mc.n_items) * mc.d * 4
    assert dense - sparse == table_stream - touched
    # scales ~linearly in batch for the non-table terms
    assert train_step_hbm_bytes(mc, 512) > train_step_hbm_bytes(mc, 256)
    # modeled traffic must cover at least the raw gather+scatter bytes
    tokens = 256 * 3 * 50
    assert sparse > 3 * tokens * mc.d * 4


def test_device_peak_lookup():
    class H100:
        device_kind = "NVIDIA H100 80GB HBM3"
    # the denominator follows the compute dtype: TF32 for f32 matmuls
    assert device_peak_flops(H100()) == 495e12
    assert device_peak_flops(H100(), "float32") == 495e12
    assert device_peak_flops(H100(), "bfloat16") == 989e12
    assert device_peak_hbm_bps(H100()) == 3.35e12


@pytest.mark.parametrize("lookup", [device_peak_flops, device_peak_hbm_bps])
def test_device_peak_unknown_device_raises(lookup):
    class Unknown:
        device_kind = "abacus"
    with pytest.raises(ValueError, match="abacus"):
        lookup(Unknown())


def test_profile_reducer_scopes_and_busy_time():
    """The trace reduction kept with the benchmark: HLO instruction →
    name-scope map (fusions inherit their fused ops' scopes) and the union
    of kernel intervals (overlaps counted once)."""
    import importlib.util
    import os

    import jax
    import jax.numpy as jnp

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_step.py")
    spec = importlib.util.spec_from_file_location("profile_step", path)
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)

    def f(x):
        with jax.named_scope("attention"):
            y = jax.nn.softmax(x @ x.T)
        return jnp.sum(y * 2.0)

    text = jax.jit(f).lower(jnp.ones((8, 8))).compile().as_text()
    scopes = ps.hlo_scopes(text)
    assert any("jit(f)/attention/" in n for v in scopes.values() for n in v)
    assert any(v and all("/attention/" not in n for n in v)
               for v in scopes.values())  # the final sum is outside
    assert ps._busy([(0, 10), (5, 15), (20, 30)]) == 25
    assert ps._busy([]) == 0
