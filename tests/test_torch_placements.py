"""The port's placement rules against the reference's, tree by tree.

Every param, batch and cache leaf of all 10 archs at full size: the
port's ``param_placements``, ``batch_shardings``,
``serve_batch_shardings`` and ``cache_shardings`` (entry tuples on fake
tensors) against the reference's ``make_param_shardings``,
``batch_shardings``, ``serve_batch_shardings`` and ``cache_shardings``
(NamedShardings on ``jax.eval_shape`` structs), on a
``jax.sharding.AbstractMesh`` of each shape: (data 2, model 2), the H100
production (data 32, model 8) and (pod 2, data 32, model 8). One-axis
tuples are normalised as ``test_torch_sharding.py`` does. The block
shapes (``local_shape``, ``local_block``) are held against
``NamedSharding.shard_shape``, and ``shard_bytes`` against the
reference's ``dryrun._shard_bytes``; ``analytic_memory`` and
``param_count`` against the reference's functions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS
from repro.configs import FLConfig as RFL
from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as rspecs
from repro.launch.dryrun import _shard_bytes as r_shard_bytes
from repro.launch.dryrun import analytic_memory as r_analytic
from repro.models import build_model as jbuild_model
from repro.sharding import spec as rspec
from repro_torch.configs import INPUT_SHAPES, FLConfig, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.models.model import build_model
from repro_torch.sharding import dist
from repro_torch.sharding import spec as tspec
from repro_torch.utils.tree import tree_flatten

MESHES = {"2x2": {"data": 2, "model": 2},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8}}
CASES = [(a, m) for a in ARCH_IDS for m in MESHES]
KINDS = ("cross_device", "cross_silo")


def _ids(c):
    return f"{c[0]}-{c[1]}"


def _rmesh(name):
    shape = MESHES[name]
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _tmesh(name):
    return dist.AbstractMesh(MESHES[name])


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its param struct, port model, its fake params)."""
    jmodel = jbuild_model(jget_config(arch), jnp.bfloat16)
    model = build_model(get_config(arch), torch.bfloat16)
    return (jmodel, jax.eval_shape(jmodel.init, jax.random.key(0)), model,
            specs.params_struct(model))


def _norm(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _ref_entries(shardings, struct, shapes=True):
    """{path: (normalised entries, block shape)} of the reference's
    NamedShardings (the block shape None where ``shapes`` is off: a
    multi-pod serving batch of 32 rows does not split 64 ways)."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(struct)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, leaf), sh in zip(leaves, shs):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        out[tuple(k.key for k in path)] = (
            tuple(_norm(e) for e in spec),
            sh.shard_shape(leaf.shape) if shapes else None)
    return out


def _port_entries(axes, struct, mesh, shapes=True):
    ax, paths = tree_flatten(axes)
    leaves, _ = tree_flatten(struct)
    return {p: (tuple(_norm(e) for e in a),
                tspec.local_shape(tuple(x.shape), a, mesh) if shapes
                else None)
            for p, a, x in zip(paths, ax, leaves)}


def _check(port, ref):
    assert set(port) == set(ref)
    for p in ref:
        assert port[p] == ref[p], p


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_param_placements_are_the_references(case):
    arch, mname = case
    _, jstruct, _, struct = _pair(arch)
    rm, tm = _rmesh(mname), _tmesh(mname)
    for kind in KINDS:
        want = _ref_entries(rspec.make_param_shardings(
            rspec.get_federation_spec(kind, rm), rm, jstruct), jstruct)
        got = _port_entries(tspec.param_placements(
            tspec.get_federation_spec(kind, tm), tm, struct), struct, tm)
        _check(got, want)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_batch_placements_are_the_references(case):
    """The round batch (C, K, b, S) under both federations and the
    serving batch (B, S), extras included."""
    arch, mname = case
    jmodel, _, model, _ = _pair(arch)
    rm, tm = _rmesh(mname), _tmesh(mname)
    for kind in KINDS:
        rs, ts = (rspec.get_federation_spec(kind, rm),
                  tspec.get_federation_spec(kind, tm))
        C = ts.clients_on(tm)
        jb = rspecs.train_specs(jmodel, R_SHAPES["train_4k"], RFL(), C)
        tb = specs.train_specs(model, INPUT_SHAPES["train_4k"], FLConfig(),
                               C)
        _check(_port_entries(tspec.batch_shardings(ts, tm, tb), tb, tm),
               _ref_entries(rspec.batch_shardings(rs, rm, jb), jb))
    for shape in ("prefill_32k", "long_500k"):
        jb = rspecs.prefill_specs(jmodel, R_SHAPES[shape])
        tb = specs.prefill_specs(model, INPUT_SHAPES[shape])
        _check(_port_entries(tspec.serve_batch_shardings(tm, tb), tb, tm,
                             False),
               _ref_entries(rspec.serve_batch_shardings(rm, jb), jb, False))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cache_placements_are_the_references(case):
    """The decode_32k cache (batch over the data axes) and long_500k's
    B = 1 cache (the next dim over model), with and without seq_shard."""
    arch, mname = case
    jmodel, _, model, _ = _pair(arch)
    rm, tm = _rmesh(mname), _tmesh(mname)
    for shape in ("decode_32k", "long_500k"):
        rsh, tsh = R_SHAPES[shape], INPUT_SHAPES[shape]
        jc, _ = rspecs.decode_specs(jmodel, rsh,
                                    rspecs.decode_window(jmodel.cfg, rsh))
        tc, _ = specs.decode_specs(model, tsh,
                                   specs.decode_window(model.cfg, tsh))
        for kind in KINDS:
            for seq in (False, True):
                want = rspec.cache_shardings(
                    rspec.get_federation_spec(kind, rm), rm, jc,
                    batch_size=rsh.global_batch, seq_shard=seq)
                got = tspec.cache_shardings(
                    tspec.get_federation_spec(kind, tm), tm, tc,
                    batch_size=tsh.global_batch, seq_shard=seq)
                _check(_port_entries(got, tc, tm), _ref_entries(want, jc))


@pytest.mark.parametrize("mname", list(MESHES))
def test_shard_bytes_and_analytic_memory_are_the_references(mname):
    """``shard_bytes`` against ``_shard_bytes`` on every arch's params,
    and ``analytic_memory`` of TinyLlama and Granite at every shape
    kind against the reference's."""
    rm, tm = _rmesh(mname), _tmesh(mname)
    for arch in ARCH_IDS:
        _, jstruct, _, struct = _pair(arch)
        for kind in KINDS:
            rs, ts = (rspec.get_federation_spec(kind, rm),
                      tspec.get_federation_spec(kind, tm))
            rsh = rspec.make_param_shardings(rs, rm, jstruct)
            tax = tspec.param_placements(ts, tm, struct)
            assert tspec.shard_bytes(struct, tax, tm) == \
                r_shard_bytes(jstruct, rsh)
            if arch not in ("tinyllama-1.1b", "granite-20b"):
                continue
            jmodel, _, model, _ = _pair(arch)
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                cache = cache_sh = jc = jcs = None
                if shape == "decode_32k":
                    jc, _ = rspecs.decode_specs(jmodel, R_SHAPES[shape], None)
                    jcs = rspec.cache_shardings(rs, rm, jc, batch_size=128)
                    cache, _ = specs.decode_specs(model,
                                                  INPUT_SHAPES[shape], None)
                    cache_sh = tspec.cache_shardings(ts, tm, cache,
                                                     batch_size=128)
                want = r_analytic(jmodel.cfg, R_SHAPES[shape], rs, rm,
                                  jstruct, rsh, RFL(), jc, jcs)
                got = dryrun.analytic_memory(
                    model.cfg, INPUT_SHAPES[shape], ts, tm, struct, tax,
                    FLConfig(), cache, cache_sh)
                assert got == want, (arch, shape, kind)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "olmoe-1b-7b", "granite-20b"])
def test_param_counts_are_the_references(arch):
    cfg = jget_config(arch)
    assert specs.param_count(get_config(arch)) == cfg.param_count()
    assert specs.param_count(get_config(arch), active_only=True) == \
        cfg.active_param_count()
    assert specs.federation_kind(get_config(arch)) == \
        rspecs.federation_kind(cfg)


@pytest.mark.parametrize("mname", list(MESHES))
def test_local_block_is_the_shard(mname):
    """Each rank's ``local_block`` has ``NamedSharding.shard_shape``,
    and the blocks of all ranks cover every element as often as the
    axes that shard nothing replicate it."""
    rm = _rmesh(mname)
    shape = MESHES[mname]
    x = torch.arange(64 * 16 * 8).reshape(64, 16, 8)
    for axes in ((tuple(a for a in ("pod", "data") if a in shape), "model",
                  None), ("model", None, None), (None, None, "model")):
        entries = tuple(a if not isinstance(a, tuple) or len(a) > 1
                        else a[0] for a in axes)
        want = NamedSharding(rm, jax.sharding.PartitionSpec(*entries)
                             ).shard_shape(tuple(x.shape))
        seen = torch.zeros_like(x)
        ranks = np.ndindex(*shape.values())
        for idx in ranks:
            coords = dict(zip(shape, idx))
            blk = tspec.local_block(x, entries, _tmesh(mname), coords)
            assert tuple(blk.shape) == want
            seen.view(-1)[blk.reshape(-1)] += 1
        n_rep = np.prod([shape[a] for a in shape
                         if a not in sum((tspec.entry_axes(e)
                                          for e in entries), ())])
        assert torch.equal(seen, torch.full_like(x, int(n_rep)))
    with pytest.raises(ValueError, match="does not split"):
        tspec.local_shape((31, 16), ("data", None), _tmesh(mname))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_moe_and_mla_prefill_caches_are_placed_as_the_references(
        arch, mesh_shape):
    """The cache the MoE and MLA decoders build at prefill (reduced
    configs, 4 prompts of 16): the port's ``cache_shardings`` of its
    cache against the reference's of ``jax.eval_shape`` of its prefill,
    under both federations, on (data 2, model 2) and (data 1, model 4):
    the rows over data where 4 splits them, and the MLA latent (no head
    dim) never split over model but where no data axis takes the rows
    (there the reference's rule puts the next dim over model)."""
    shape = dict(zip(("data", "model"), mesh_shape))
    rm = AbstractMesh(mesh_shape, ("data", "model"))
    tm = dist.AbstractMesh(shape)
    cfg = get_config(arch).reduced(num_layers=2, d_model=64)
    jmodel = jbuild_model(jget_config(arch).reduced(num_layers=2,
                                                    d_model=64))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((4, 16), dtype=torch.long)
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=24)
    jparams = jax.eval_shape(jmodel.init, jax.random.key(0))
    _, jc = jax.eval_shape(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, cache_len=24), jparams,
        jax.ShapeDtypeStruct((4, 16), jnp.int32))
    for kind in KINDS:
        want = _ref_entries(rspec.cache_shardings(
            rspec.get_federation_spec(kind, rm), rm, jc, batch_size=4), jc)
        got = _port_entries(tspec.cache_shardings(
            tspec.get_federation_spec(kind, tm), tm, cache, batch_size=4),
            cache, tm)
        _check(got, want)
        if cfg.use_mla and mesh_shape[0] > 1:
            assert got[("runs", "run0", "c_kv")][0] == ((), ("data",), (),
                                                         ())
