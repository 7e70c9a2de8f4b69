"""Port parity: ``repro_torch.core.flat`` lays out, packs and unpacks
param trees exactly as ``repro.core.flat`` does — same leaf order (JAX's
sorted keys), offsets, padded size and round mask — for the paper's MLP,
the shallow CNN and a mixed bf16/f32 tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_tasks import CNN_PAPER, MLP_SMALL, MLP_WIDE
from repro.core import flat as rflat
from repro.models.small import make_small_model as rmake
from repro_torch import interop
from repro_torch.core import flat as tflat
from repro_torch.utils import tree as ttree


def _mixed(rng):
    return {"z": {"w": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32),
                  "b": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16)},
            "a": jnp.asarray(rng.normal(size=()), jnp.float32),
            "m": {"k": jnp.asarray(rng.normal(size=(2, 2, 3)),
                                   jnp.bfloat16)}}


def _ref_tree(name, rng):
    if name == "mixed":
        return _mixed(rng)
    cfg = {"mlp": MLP_SMALL, "mlp-wide": MLP_WIDE, "cnn": CNN_PAPER}[name]
    return rmake(cfg)[0](jax.random.key(0))


def _paths(tree):
    return [tuple(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


TREES = ["mlp", "mlp-wide", "cnn", "mixed"]


@pytest.mark.parametrize("name", TREES)
def test_layout_matches_reference(name, rng):
    rt = _ref_tree(name, rng)
    tt = interop.params_from_numpy(jax.device_get(rt))
    rl, tl = rflat.layout_of(rt), tflat.layout_of(tt)
    assert list(tl.treedef) == _paths(rt)
    assert (tl.size, tl.padded_size) == (rl.size, rl.padded_size)
    for a, b in zip(rl.leaves, tl.leaves):
        assert (a.offset, a.size, tuple(a.shape)) == (b.offset, b.size,
                                                      b.shape)
        assert str(jnp.dtype(a.dtype)) == str(b.dtype).split(".")[-1]
    rm, tm = rflat.round_mask(rl), tflat.round_mask(tl)
    assert (rm is None) == (tm is None)
    if rm is not None:
        np.testing.assert_array_equal(np.asarray(rm), tm.numpy())


def test_cnn_paper_layout_size():
    """The paper's CNN: 71,754 params, padded to N = 71,808."""
    tt = interop.params_from_numpy(
        jax.device_get(rmake(CNN_PAPER)[0](jax.random.key(0))))
    layout = tflat.layout_of(tt)
    assert (layout.size, layout.padded_size) == (71754, 71808)
    assert [p for p, _ in zip(layout.treedef, range(3))] == [
        ("conv1", "b"), ("conv1", "w"), ("conv2", "b")]


@pytest.mark.parametrize("name", TREES)
def test_pack_unpack_matches_reference_and_roundtrips(name, rng):
    rt = _ref_tree(name, rng)
    tt = interop.params_from_numpy(jax.device_get(rt))
    layout = tflat.layout_of(tt)
    buf = tflat.pack(tt, layout)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(rflat.pack(rt)))
    back = tflat.unpack(buf, layout)
    for a, b in zip(ttree.tree_leaves(tt), ttree.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # batched: C copies with distinct values
    C = 3
    rb = jax.tree.map(lambda l: jnp.stack([l * (c + 1) for c in range(C)]),
                      rt)
    tb = interop.params_from_numpy(jax.device_get(rb))
    bl = tflat.layout_of(tb, batched=True)
    assert bl == layout
    P = tflat.pack_batched(tb, bl)
    np.testing.assert_array_equal(P.numpy(),
                                  np.asarray(rflat.pack_batched(rb)))
    back = tflat.unpack_batched(P, bl)
    for a, b in zip(ttree.tree_leaves(tb), ttree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(P[:, layout.size:].numpy(), 0.0)


def test_tree_order_is_sorted_not_insertion():
    t = {"b": torch.ones(1), "a": {"y": torch.zeros(2), "x": torch.ones(3)}}
    leaves, treedef = ttree.tree_flatten(t)
    assert treedef == (("a", "x"), ("a", "y"), ("b",))
    assert [l.numel() for l in leaves] == [3, 2, 1]
    assert ttree.tree_unflatten(treedef, leaves).keys() == {"a", "b"}


def test_interop_roundtrip_keeps_dtypes(rng):
    rt = jax.device_get(_mixed(rng))
    back = interop.params_to_numpy(interop.params_from_numpy(rt))
    for a, b in zip(jax.tree_util.tree_leaves(rt),
                    ttree.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_sharded_layout_not_ported():
    """Sharded layouts were refused until the multi-device slice ported
    them: ``shards=2`` now pads as the reference's layout does, and a
    shard count below one is refused as the reference refuses it."""
    tree = {"x": torch.zeros(4)}
    lay = tflat.layout_of(tree, shards=2)
    ref = rflat.layout_of({"x": jnp.zeros(4)}, shards=2)
    assert (lay.shards, lay.padded_size) == (2, ref.padded_size)
    with pytest.raises(ValueError, match="shards must be >= 1"):
        tflat.layout_of(tree, shards=0)
