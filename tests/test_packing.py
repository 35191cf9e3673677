"""Lane-packed embedding tables (ops/packed_table.py): packing is a
storage-only transform — lookups, model outputs, and gradients must match
the unpacked table exactly, including through the row-sharded collective."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from carca_tpu.config import ModelConfig
from carca_tpu.ops.packed_table import (lookup_maybe_packed, pack_factor,
                                        pack_rows, unpack_rows)
from tests.conftest import skip_unless_devices


def test_pack_factor_rules():
    # "auto" never packs: the GPU stores narrow rows densely
    assert pack_factor(64, 10_000_000, "auto") == 1
    assert pack_factor(64, 1000, "auto") == 1
    assert pack_factor(64, 1000, True) == 2
    assert pack_factor(64, 10_000_000, False) == 1
    assert pack_factor(128, 10_000_000, True) == 1  # already lane-full
    assert pack_factor(12, 10_000_000, True) == 1  # 128 % 12 != 0
    assert pack_factor(32, 2_000_000, True) == 4


def test_pack_unpack_roundtrip():
    t = np.arange(7 * 64, dtype=np.float32).reshape(7, 64)
    p = pack_rows(t, 2)
    assert p.shape == (4, 128)
    back = unpack_rows(p, 64)
    np.testing.assert_array_equal(back[:7], t)
    assert (back[7:] == 0).all()


def test_lookup_matches_take_values_and_grads():
    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (101, 32))
    packed = pack_rows(table, 4)
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 101, (5, 7)))
    take = lambda t, i: jnp.take(t, i, axis=0)

    out = lookup_maybe_packed(take, packed, ids, 32)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(jnp.take(table, ids, axis=0)))

    def loss_packed(t):
        return jnp.sum(jnp.sin(lookup_maybe_packed(take, t, ids, 32)))

    def loss_plain(t):
        return jnp.sum(jnp.sin(jnp.take(t, ids, axis=0)))

    g_packed = jax.grad(loss_packed)(packed)
    g_plain = jax.grad(loss_plain)(table)
    np.testing.assert_allclose(np.asarray(unpack_rows(g_packed, 32)[:101]),
                               np.asarray(g_plain), rtol=1e-6)


@pytest.mark.parametrize("embedding", ["all", "id", "mlpid"])
def test_model_identical_packed_vs_plain(embedding):
    from carca_tpu.models.carca import carca_apply, carca_init

    def cfg(pack):
        return ModelConfig(n_items=97, n_attrs=8, n_ctx=4, d=16, g=32,
                           seq_len=6, target_len=5, n_blocks=1, n_heads=2,
                           dropout=0.0, embedding=embedding,
                           pack_tables=pack)

    key = jax.random.PRNGKey(3)
    plain = carca_init(key, cfg(False))
    packed = carca_init(key, cfg(True))
    w = 32 if embedding == "mlpid" else 16
    assert packed["embed"]["items"].shape[-1] > w  # actually packed
    np.testing.assert_array_equal(
        np.asarray(pack_rows(plain["embed"]["items"], 128 // w)),
        np.asarray(packed["embed"]["items"]))

    rng = np.random.default_rng(0)
    attrs = jnp.asarray(rng.normal(size=(97, 8)), jnp.float32)
    p_x = jnp.asarray(rng.integers(0, 97, (4, 6)), jnp.int32)
    p_c = jnp.asarray(rng.normal(size=(4, 6, 4)), jnp.float32)
    o_x = jnp.asarray(rng.integers(1, 97, (4, 5)), jnp.int32)
    o_c = jnp.asarray(rng.normal(size=(4, 5, 4)), jnp.float32)

    def fwd(params, pack):
        return carca_apply(params, cfg(pack), (p_x, None, p_c),
                           [(o_x, None, o_c)], train=False,
                           attrs_table=attrs)

    np.testing.assert_array_equal(np.asarray(fwd(plain, False)),
                                  np.asarray(fwd(packed, True)))

    g_plain = jax.grad(lambda p: jnp.sum(fwd(p, False)))(plain)
    g_packed = jax.grad(lambda p: jnp.sum(fwd(p, True)))(packed)
    np.testing.assert_allclose(
        np.asarray(pack_rows(g_plain["embed"]["items"], 128 // w)),
        np.asarray(g_packed["embed"]["items"]), rtol=1e-6, atol=1e-7)


def test_packed_through_sharded_lookup():
    """Packing composes with the row-sharded shard_map lookup: packed rows
    are still rows."""
    skip_unless_devices(8)
    from carca_tpu.parallel import make_mesh, make_sharded_lookup
    from carca_tpu.parallel.mesh import pad_table_rows

    mesh = make_mesh((2, 4), ("data", "model"))
    table = jax.random.normal(jax.random.PRNGKey(1), (101, 32))
    packed = jnp.asarray(pad_table_rows(np.asarray(pack_rows(table, 4)), mesh))
    ids = jnp.asarray(np.random.default_rng(1).integers(0, 101, (8, 5)))
    lookup = make_sharded_lookup(mesh)
    out = lookup_maybe_packed(lookup, packed, ids, 32)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(jnp.take(table, ids, axis=0)),
                               rtol=1e-6)


def test_retrieval_with_packed_items():
    """full_catalog_topk unpacks lane-packed item tables transparently
    (single-device and sharded paths agree with the plain table)."""
    from carca_tpu.models.carca import carca_init
    from carca_tpu.parallel.retrieval import full_catalog_topk

    def cfg(pack):
        return ModelConfig(n_items=97, n_attrs=8, n_ctx=4, d=16, g=32,
                           seq_len=6, target_len=5, n_blocks=1, n_heads=2,
                           dropout=0.0, embedding="all", decoder="dot",
                           pack_tables=pack)

    key = jax.random.PRNGKey(5)
    plain = carca_init(key, cfg(False))
    packed = carca_init(key, cfg(True))
    rng = np.random.default_rng(2)
    attrs = jnp.asarray(rng.normal(size=(97, 8)), jnp.float32)
    profile = (jnp.asarray(rng.integers(0, 97, (4, 6)), jnp.int32), None,
               jnp.asarray(rng.normal(size=(4, 6, 4)), jnp.float32))

    v0, i0 = full_catalog_topk(plain, cfg(False), profile, attrs, 5)
    v1, i1 = full_catalog_topk(packed, cfg(True), profile, attrs, 5)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), rtol=1e-5)
