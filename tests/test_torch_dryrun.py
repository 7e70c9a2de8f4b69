"""The dry run of the serving programs on the H100 production mesh.

TinyLlama-1.1B's ``prefill_32k`` and ``decode_32k`` at full size, one
rank of the abstract (data 32, model 8) mesh on fake tensors: the
result's fields, its collectives (``serve_collectives``), its argument
bytes and ``analytic_memory`` against the reference's functions on the
same placements (the reference's NamedShardings on a
``jax.sharding.AbstractMesh``), and the counted FLOPs within 1 % of
2·N·tokens plus the attention term derived here for the rank's heads.
The roofline terms, ``model_flops`` and the ring ``wire_bytes`` against
the reference's ``roofline.py``; the CLI's refusals.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import roofline as rroof
from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import FLConfig as RFL
from repro.configs import get_config as jget_config
from repro.launch import specs as rspecs
from repro.launch.dryrun import analytic_memory as r_analytic
from repro.models import build_model as jbuild_model
from repro.sharding import spec as rspec
from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import serve_collectives, serve_rules
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def runs():
    return {s: dryrun.lower_one(ARCH, s, False, verbose=False)
            for s in ("prefill_32k", "decode_32k")}


def _flops(cfg, shape):
    """One rank's matmul FLOPs at (data 32, model 8): its block of every
    layer's projections (query heads, MLP units; the 4 KV heads whole,
    as 4 does not split 8 ways), the head's vocab block at the last
    position, and attention: the plain route's full S×S scores and
    values at prefill, the one query against the cache at decode."""
    D, L, hd = cfg.d_model, cfg.num_layers, cfg.head_dim
    h, f, v = cfg.num_heads // 8, cfg.d_ff // 8, cfg.padded_vocab // 8
    n_layer = D * h * hd + 2 * D * cfg.num_kv_heads * hd + h * hd * D \
        + 3 * D * f
    B = shape.global_batch // 32
    if shape.kind == "prefill":
        tokens, T = B * shape.seq_len, shape.seq_len
        attn = 2 * 2 * B * h * shape.seq_len * T * hd
    else:
        tokens, T = B, shape.seq_len
        attn = 2 * 2 * B * h * T * hd
    return 2 * L * n_layer * tokens + 2 * D * v * B + L * attn


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_counts_the_work_of_one_rank(shape, runs):
    res = runs[shape]
    cfg = get_config(ARCH)
    assert (res["mesh"], res["chips"], res["federation"], res["clients"],
            res["step_kind"]) == ("32x8", 256, "cross_device", 32,
                                  shape.split("_")[0])
    assert res["param_count"] == jget_config(ARCH).param_count()
    want = _flops(cfg, dryrun.INPUT_SHAPES[shape])
    assert abs(res["roofline"]["flops"] - want) <= 0.01 * want
    assert res["roofline"]["hbm_bytes"] > res["memory"][
        "argument_size_in_bytes"] > 0
    assert res["lower_s"] < 60
    # the rank's collectives: 2 partial-sum reduces a layer and the two
    # vocab ops; the 4 KV heads are whole on every rank of 8
    model = build_model(cfg, torch.bfloat16)
    mesh = dist.AbstractMesh({"data": 32, "model": 8})
    from repro_torch.launch.specs import params_struct
    rules = serve_rules(model, mesh, params_struct(model))
    rows, seq = (1, 32768) if shape == "prefill_32k" else (4, 1)
    want_ops = {k: n for k, n in serve_collectives(model, rules, rows,
                                                   seq).items() if n}
    assert res["collectives"] == want_ops == {"tp_reduce": 44, "vocab": 2}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_memory_is_the_references(shape, runs):
    """``analytic_memory`` and the params' bytes a device equal the
    reference's on its placements of the same structs."""
    res = runs[shape]
    rm = AbstractMesh((32, 8), ("data", "model"))
    jmodel = jbuild_model(jget_config(ARCH), jnp.bfloat16)
    pstruct = jax.eval_shape(jmodel.init, jax.random.key(0))
    spec = rspec.get_federation_spec("cross_device", rm)
    psh = rspec.make_param_shardings(spec, rm, pstruct)
    cache = csh = None
    rshape = R_SHAPES[shape]
    if rshape.kind == "decode":
        cache, tok = rspecs.decode_specs(jmodel, rshape, None)
        csh = rspec.cache_shardings(spec, rm, cache,
                                    batch_size=rshape.global_batch)
    want = r_analytic(jmodel.cfg, rshape, spec, rm, pstruct, psh, RFL(),
                      cache, csh)
    assert res["analytic_memory"] == want
    if rshape.kind == "decode":
        toks = rshape.global_batch // 32 * 4
        assert res["memory"]["argument_size_in_bytes"] == \
            want["params_dev"] + want["cache"] + toks


def test_roofline_terms_are_the_references():
    """The same counts give the reference's terms over its constants and
    the port's over the H100's; ring wire bytes are the reference's."""
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "all-to-all", "collective-permute"):
        for n in (1, 2, 8, 32):
            assert hlo.CollectiveOp(kind, 1 << 20, n).wire_bytes == \
                rroof.CollectiveOp(kind, 1 << 20, n).wire_bytes
    r = rroof.Roofline(3e15, 2e12, 5e9, 256)
    t = roofline.Roofline(3e15, 2e12, 5e9, 256)
    assert t.t_compute * roofline.PEAK_FLOPS == pytest.approx(
        r.t_compute * rroof.PEAK_FLOPS, rel=1e-12)
    assert t.t_memory * roofline.HBM_BW == pytest.approx(
        r.t_memory * rroof.HBM_BW, rel=1e-12)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    # a group on model stays in the host's NVLink, one on data leaves it
    w = roofline.Work(1.0, 1.0, [
        hlo.CollectiveOp("all-reduce", 1 << 20, 8, ("model",)),
        hlo.CollectiveOp("all-gather", 1 << 20, 32, ("data",))])
    rl = roofline.analyze(w, 256)
    assert rl.t_collective == pytest.approx(
        2 * 7 / 8 * (1 << 20) / 450e9 + 31 / 32 * (1 << 20) / 50e9)
    for arch in ("tinyllama-1.1b", "granite-20b", "olmoe-1b-7b"):
        assert roofline.model_flops(get_config(arch), 4096) == \
            rroof.model_flops(jget_config(arch), 4096)


def test_dryrun_cli_lists_refusals_apart(tmp_path, capsys):
    dryrun.main(["--arch", ARCH, "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    # a global batch of 32 rows does not split over the multi-pod
    # mesh's 64 data ranks
    dryrun.main(["--arch", "granite-20b", "--shape", "prefill_32k",
                 "--mesh", "multi", "--out", str(tmp_path)])
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    # InternVL2's 14 heads do not split over 8 ranks
    dryrun.main(["--arch", "internvl2-1b", "--shape", "train_4k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "1 dry runs passed" in out
    assert out.count("1 refused:") == 2 and "2 refused:" in out
    assert "failures" not in out
    res = json.loads((tmp_path / f"{ARCH}_decode_32k_single.json"
                      ).read_text())
    assert res["roofline"]["bottleneck"] in ("memory", "compute",
                                             "collective")
    # --scenario-smoke runs (tests/test_torch_train_builders.py)


def test_production_mesh_without_ranks_is_abstract():
    """No process group here: the production meshes are abstract, H100
    hosts of 8 on ``model``."""
    from repro_torch.launch.mesh import make_production_mesh
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True, coords={"pod": 1})
    assert isinstance(single, dist.AbstractMesh)
    assert (single.shape, single.size) == ({"data": 32, "model": 8}, 256)
    assert (multi.shape, multi.size, multi.coords) == (
        {"pod": 2, "data": 32, "model": 8}, 512,
        {"pod": 1, "data": 0, "model": 0})
    with pytest.raises(ValueError, match="off the mesh"):
        dist.AbstractMesh({"data": 2}, {"data": 2})


# ------------------------------------------------- the MoE and MLA decoders
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")


@pytest.fixture(scope="module")
def moe_runs():
    return {(a, s): dryrun.lower_one(a, s, False, verbose=False)
            for a in MOE_ARCHS for s in ("prefill_32k", "decode_32k")}


def _moe_flops(cfg, shape):
    """One rank's matmul FLOPs at (data 32, model 8), the rank's 1/8 of
    the heads, experts, shared units and vocab: attention's projections
    (GQA's; MLA's replicated latents and its heads' up-projections, the
    prefill expanding K and V, the decode absorbing them), attention
    (the full S×S scores and values at prefill, one query against the
    32,768-entry cache at decode), the replicated router, the E/8
    experts' three GEMMs at the capacity of the global batch (the slots
    of other data ranks' tokens stay empty, as in the reference's
    buffer), the shared expert, and the head at the last position."""
    D, L, E, K = cfg.d_model, cfg.num_layers, cfg.num_experts, \
        cfg.num_experts_per_tok
    h, v, El = cfg.num_heads // 8, cfg.padded_vocab // 8, E // 8
    B = shape.global_batch // 32
    prefill = shape.kind == "prefill"
    tokens = B * shape.seq_len if prefill else B
    T = shape.seq_len
    if cfg.use_mla:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        proj = D * qr + qr * h * (dn + dr) + D * (kvr + dr) + h * dv * D
        if prefill:
            proj += kvr * h * (dn + dv)
            attn = 2 * B * h * shape.seq_len * T * (dn + dr + dv)
        else:
            proj += h * dn * kvr + h * kvr * dv
            attn = 2 * B * h * T * (kvr + dr + kvr)
    else:
        hd = cfg.head_dim
        proj = 4 * D * h * hd
        attn = 2 * 2 * B * h * (shape.seq_len if prefill else 1) * T * hd
    C = moe._capacity(shape.global_batch * (shape.seq_len if prefill
                                            else 1), E, K)
    shared = 3 * D * cfg.expert_d_ff * cfg.num_shared_experts // 8
    per_token = proj + D * E + shared
    experts = 3 * 2 * El * C * D * cfg.expert_d_ff
    return 2 * L * per_token * tokens + L * (attn + experts) + 2 * D * v * B


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_moe_dryrun_counts_the_work_of_one_rank(arch, shape, moe_runs):
    """OLMoE (8 experts and 2 heads a rank) and DeepSeek-V3 (32 experts
    and 16 heads a rank) on the production mesh: the counted FLOPs
    within 1 % of ``_moe_flops``, the collectives ``serve_collectives``',
    the analytic memory the reference's."""
    from repro_torch.launch.specs import params_struct
    res = moe_runs[(arch, shape)]
    cfg = get_config(arch)
    want = _moe_flops(cfg, dryrun.INPUT_SHAPES[shape])
    assert abs(res["roofline"]["flops"] - want) <= 0.01 * want
    model = build_model(cfg, torch.bfloat16)
    mesh = dist.AbstractMesh({"data": 32, "model": 8})
    rules = serve_rules(model, mesh, params_struct(model),
                        batch_size=dryrun.INPUT_SHAPES[shape].global_batch)
    rows, seq = (1, 32768) if shape == "prefill_32k" else (4, 1)
    want_ops = {k: n for k, n in serve_collectives(model, rules, rows,
                                                   seq).items() if n}
    assert res["collectives"] == want_ops
    assert want_ops["moe_counts"] == cfg.num_layers
    rm = AbstractMesh((32, 8), ("data", "model"))
    jmodel = jbuild_model(jget_config(arch), jnp.bfloat16)
    pstruct = jax.eval_shape(jmodel.init, jax.random.key(0))
    spec = rspec.get_federation_spec(res["federation"], rm)
    psh = rspec.make_param_shardings(spec, rm, pstruct)
    cache = csh = None
    rshape = R_SHAPES[shape]
    if rshape.kind == "decode":
        cache, _ = rspecs.decode_specs(jmodel, rshape, None)
        csh = rspec.cache_shardings(spec, rm, cache,
                                    batch_size=rshape.global_batch)
    assert res["analytic_memory"] == r_analytic(
        jmodel.cfg, rshape, spec, rm, pstruct, psh, RFL(), cache, csh)


def test_moe_dryrun_train_4k_completes():
    """OLMoE's and DeepSeek-V3's ``train_4k`` vmap rounds (remat on; K =
    2 for OLMoE, the CLI's default, and K = 1 for DeepSeek-V3, whose 61
    layers take about 100 s a local step on fake tensors here) on one
    rank's fake blocks: the collectives ``train_collectives``' (OLMoE
    ``cross_device``: no count crosses data; DeepSeek-V3 ``cross_silo``:
    its rows split over the 32 data ranks, so each MoE layer gathers its
    counts and sums its aux over ``data``, and the MTP block gathers
    ``proj``'s output), the analytic memory the reference's."""
    from repro_torch.launch.specs import params_struct
    from repro_torch.launch.steps import train_collectives, train_rules
    for arch, K in zip(MOE_ARCHS, (2, 1)):
        res = dryrun.lower_one(arch, "train_4k", False, local_steps=K,
                               verbose=False)
        cfg = get_config(arch)
        model = build_model(cfg, torch.bfloat16)
        mesh = dist.AbstractMesh({"data": 32, "model": 8})
        spec = get_federation_spec(res["federation"], mesh)
        rules = train_rules(model, mesh, params_struct(model), spec=spec)
        want = train_collectives(model, rules, local_steps=K, remat=True)
        assert res["collectives"] == want
        silo = res["federation"] == "cross_silo"
        assert (want.get("moe_counts", 0) == K * (2 * cfg.num_layers
                                                  + bool(cfg.mtp_depth))
                ) == silo
        assert ("mtp_gather" in want) == bool(cfg.mtp_depth)
        assert res["roofline"]["flops"] > 0
        rm = AbstractMesh((32, 8), ("data", "model"))
        jmodel = jbuild_model(jget_config(arch), jnp.bfloat16)
        pstruct = jax.eval_shape(jmodel.init, jax.random.key(0))
        rsp = rspec.get_federation_spec(res["federation"], rm)
        psh = rspec.make_param_shardings(rsp, rm, pstruct)
        assert res["analytic_memory"] == r_analytic(
            jmodel.cfg, R_SHAPES["train_4k"], rsp, rm, pstruct, psh,
            RFL(), None, None)
        assert res["local_steps"] == K
