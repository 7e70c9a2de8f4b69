"""``launch/perf.py`` on the port's dry run: each family of the
reference's variants on one pair, on fake tensors under the abstract
(data 32, model 8) mesh, counted at the two calibration depths and
extrapolated.

  * the variant names are the reference's 17 (read from the reference's
    module with ``ast``: importing it would set ``XLA_FLAGS`` to 512
    host devices for every later test of the worker);
  * the extrapolation of TinyLlama's ``decode_32k`` from one and two
    layers equals the dry run's full-depth (22-layer) count;
  * quant_kv + cache_seq_shard, softmax_bf16, expert_2d + capacity1,
    flat_fed, the sharded flat round under a scenario, the fused block
    and the faults round run; every ``flat_fed_sharded*`` variant holds
    ``hlo.assert_flat_buffer_sharded`` (the faults round prints the
    boundary check's skip note with one client a shard), and its
    ``wire`` record equals the reference's ``level_wire_bytes`` on the
    reference's layout size of the same arch (``jax.eval_shape`` of its
    init) a client;
  * each switch is restored after its variant, and ``seq_shard`` is
    refused naming ROADMAP A17 while ``main`` exits 0.
"""
import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.compression import CompressionSpec as RSpec
from repro.configs import get_config as jget_config
from repro.core import flat as rflat
from repro.models import build_model as jbuild_model
from repro_torch.launch import dryrun, perf
from repro_torch.models import attention, moe

REF_PERF = Path(__file__).resolve().parents[1] / "src/repro/launch/perf.py"
RUNS = (("tinyllama-1.1b/decode_32k", "baseline"),
        ("tinyllama-1.1b/decode_32k", "quant_kv+cache_seq_shard"),
        ("tinyllama-1.1b/prefill_32k", "softmax_bf16"),
        ("olmoe-1b-7b/train_4k", "expert_2d+capacity1"),
        ("tinyllama-1.1b/train_4k", "flat_fed"),
        ("tinyllama-1.1b/train_4k", "flat_fed_hetero"),
        ("tinyllama-1.1b/train_4k", "flat_fed_rounds_fused"),
        ("tinyllama-1.1b/train_4k", "flat_fed_faults"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def measured():
    """{(pair, variant): (summary, printed lines)}: each run once."""
    import contextlib
    import io
    out = {}
    for pair, v in RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = perf.measure(*pair.split("/"), v)
        out[(pair, v)] = (res, buf.getvalue())
        # the switches are back at their defaults after each variant
        assert attention.SOFTMAX_BF16 is False
        assert moe.CAPACITY_FACTOR == 1.25
    return out


def test_variant_names_are_the_references():
    tree = ast.parse(REF_PERF.read_text())
    names = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "VARIANT_KNOBS"
                for t in node.targets):
            names = [k.value for k in node.value.keys]
    assert names is not None and len(names) == 17
    assert list(perf.VARIANT_KNOBS) == names


def test_calibration_depths_are_one_and_two_pattern_cycles():
    from repro_torch.configs import get_config
    assert perf._calib_depths(get_config("tinyllama-1.1b")) == (1, 2)
    z = get_config("zamba2-7b")
    assert perf._calib_depths(z) == (len(z.block_pattern),
                                     2 * len(z.block_pattern))
    assert perf._at_depth(z, 3).num_layers == 3


def test_extrapolation_equals_the_full_depth_count(measured):
    """Decode is a fixed part plus 22 identical layers: the count at one
    and two layers, extrapolated, is the full count."""
    got, _ = measured[("tinyllama-1.1b/decode_32k", "baseline")]
    full = dryrun.lower_one("tinyllama-1.1b", "decode_32k", False,
                            verbose=False)["roofline"]
    for k in ("flops", "hbm_bytes", "coll_bytes", "t_collective_s"):
        assert got[k] == pytest.approx(full[k], rel=1e-9), k
    assert got["coll_by_kind"] == pytest.approx(full["coll_by_kind"],
                                                rel=1e-9)
    assert got["calibration_depths"] == [1, 2]


@pytest.mark.parametrize("pair,variant", RUNS)
def test_each_variant_family_lowers(pair, variant, measured):
    """Every term counted; ``flat_fed`` runs off the mesh (each rank's
    clients whole), so it makes no collective."""
    res, _ = measured[(pair, variant)]
    for k in ("t_compute_s", "t_memory_s"):
        assert res[k] > 0, k
    assert (res["t_collective_s"] == 0) == (variant == "flat_fed")
    assert res["bottleneck"] in ("compute", "memory", "collective")


def test_the_switches_change_the_count(measured):
    """int8 entries and the time-cut cache shrink a decode step's bytes
    and add the time blocks' sums; bf16 probabilities keep a prefill's
    FLOPs and change its bytes (eager ops: the f32 exponent, its bf16
    copy and the f32 sum each move the (S, T) block)."""
    base, _ = measured[("tinyllama-1.1b/decode_32k", "baseline")]
    cut, _ = measured[("tinyllama-1.1b/decode_32k",
                       "quant_kv+cache_seq_shard")]
    assert cut["hbm_bytes"] < base["hbm_bytes"]
    assert cut["collectives_at_depth2"].get("seq_sum", 0) > 0
    bf16, _ = measured[("tinyllama-1.1b/prefill_32k", "softmax_bf16")]
    f32 = perf.measure("tinyllama-1.1b", "prefill_32k", "baseline")
    assert bf16["flops"] == f32["flops"]
    assert bf16["hbm_bytes"] != f32["hbm_bytes"]


@pytest.mark.parametrize("variant", ["flat_fed_hetero",
                                     "flat_fed_rounds_fused",
                                     "flat_fed_faults"])
def test_sharded_flat_variants_hold_the_buffer_checks(variant, measured):
    res, text = measured[("tinyllama-1.1b/train_4k", variant)]
    assert text.count("flat buffer stays sharded") == 2
    assert res["collectives_at_depth2"].get("flat_reshard", 0) >= 1
    if variant == "flat_fed_faults":
        assert text.count("boundary check skipped") == 2


def test_wire_record_is_the_references_level_wire_bytes(measured):
    res, _ = measured[("tinyllama-1.1b/train_4k", "flat_fed_faults")]
    w = res["wire"]
    cfg = jget_config("tinyllama-1.1b")
    pstruct = jax.eval_shape(jbuild_model(cfg, jnp.bfloat16).init,
                             jax.random.key(0))
    size = rflat.layout_of(pstruct).size
    comp = RSpec(kind="int8", error_feedback=True)
    table = comp.level_wire_bytes(size)
    assert w["kind"] == "int8" and w["clients"] == 32
    assert w["wire_bytes_round"] / w["clients"] == float(table[comp.level])
    assert w["uncompressed_bytes_round"] / w["clients"] == float(table[0])
    assert w["comp_ratio"] == float(table[0]) / float(table[comp.level])


def test_main_refuses_seq_shard_and_reuses_the_baseline(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    art = tmp_path / "experiments/dryrun"
    art.mkdir(parents=True)
    rl = {"t_compute_s": 1.0, "t_memory_s": 2.0, "t_collective_s": 3.0,
          "bottleneck": "collective"}
    (art / "tinyllama-1.1b_decode_32k_single.json").write_text(
        json.dumps({"roofline": rl}))
    perf.main(["--pair", "tinyllama-1.1b/decode_32k", "--variants",
               "baseline,seq_shard,seq_shard+softmax_bf16", "--out",
               str(tmp_path / "perf")])
    text = capsys.readouterr().out
    assert "[baseline] reused sweep artifact" in text
    assert text.count("ROADMAP A17") == 2
    got = json.loads((tmp_path / "perf/tinyllama-1.1b_decode_32k.json")
                     .read_text())
    assert got["baseline"] == rl
    assert "ROADMAP A17" in got["seq_shard"]["refused"]
    assert os.path.exists(tmp_path / "perf")
