"""Parity of the port's ``roofline.extrapolate``, ``launch/report.py``
tables and CLI, and the bf16-softmax switch with the reference's.

  * ``extrapolate`` on the reference test's numbers
    (``tests/test_roofline.py``) gives the reference's terms, and the
    port's collective seconds lie on the same line;
  * ``dryrun_table``, ``roofline_table``, ``scenario_table`` and
    ``main``'s output on the same rows are the reference's string for
    string, the single-pod mesh string aside (the reference's TPU pod
    is "16x16", the H100 mesh "32x8");
  * ``attention._sdpa`` with ``SOFTMAX_BF16`` set (and restored in a
    ``finally``) is the reference's with its switch set, within one
    bf16 rounding of the product.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
from repro import roofline as rroof
from repro.launch import report as rreport
from repro_torch import roofline as troof
from repro_torch.launch import report as treport
from repro_torch.models import attention as tattn


def _pair(mod, **kw):
    return mod.Roofline(**kw)


def test_extrapolate_is_the_references():
    a = dict(flops=10.0, hbm_bytes=100.0, coll_bytes=4.0, chips=2,
             coll_by_kind={"all-reduce": 4.0})
    b = dict(flops=16.0, hbm_bytes=140.0, coll_bytes=6.0, chips=2,
             coll_by_kind={"all-reduce": 4.0, "all-gather": 2.0})
    want = rroof.extrapolate(_pair(rroof, **a), _pair(rroof, **b), 1, 2, 10)
    got = troof.extrapolate(_pair(troof, **a, coll_seconds=0.5),
                            _pair(troof, **b, coll_seconds=0.75), 1, 2, 10)
    for k in ("flops", "hbm_bytes", "coll_bytes", "chips"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.coll_by_kind == want.coll_by_kind
    assert got.coll_seconds == pytest.approx(0.5 + 0.25 * 9)
    # negative extrapolations clamp at 0, as the reference's
    c = dict(flops=10.0, hbm_bytes=0, coll_bytes=0, chips=2)
    d = dict(flops=5.0, hbm_bytes=0, coll_bytes=0, chips=2)
    assert troof.extrapolate(_pair(troof, **c), _pair(troof, **d), 1, 2,
                             10).flops == rroof.extrapolate(
        _pair(rroof, **c), _pair(rroof, **d), 1, 2, 10).flops == 0.0
    assert troof.extrapolate(_pair(troof, **c), _pair(troof, **d), 1, 2,
                             10).coll_seconds is None


def _rows(mesh):
    rl = {"t_compute_s": 2.5e-4, "t_memory_s": 0.125,
          "t_collective_s": 3.2, "bottleneck": "collective",
          "coll_by_kind": {"all-reduce": 5e9, "all-gather": 7e10}}
    dry = [
        {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": mesh,
         "federation": "cross_device", "clients": 32, "compile_s": 0.0,
         "memory": {"temp_size_in_bytes": 0},
         "analytic_memory": {"total": 3.1e10}, "roofline": rl,
         "useful_flops_ratio": 0.4321},
        {"arch": "qwen2.5-14b", "shape": "decode_32k", "mesh": mesh,
         "federation": "cross_silo", "clients": 1, "compile_s": None,
         "analytic_memory": {"total": 512},
         "roofline": dict(rl, t_compute_s=0.0, coll_by_kind={})},
        {"arch": "zamba2-7b", "shape": "prefill_32k", "mesh": "2x" + mesh,
         "roofline": rl},
        {"arch": "xlstm-1.3b", "mesh": mesh, "roofline": {"note": "x"}},
    ]
    scen = [
        {"scenario": "zipf_async", "rounds": 4, "clients_seen": 17,
         "cohort_top1_share": 0.125, "cohort_top5_share": 0.5,
         "stale_mean": 1.25, "stale_max": 3.0, "k_eff_mean": 6.5,
         "k_eff_min": 2.0, "k_eff_max": 7.0, "flush_rate": 0.5,
         "wire_bytes_round": 2.5e6, "comp_ratio": 3.9,
         "valid_mean": 9.5, "skipped_rounds": 1.0, "eta_clip_rate": 0.0,
         "nan_guard_rate": 0.05, "eta_hist": [1, 2, 3, 0],
         "eta_hist_edges": [0.0, 1e-3, 1e-2, 1e-1]},
        {"scenario": "sync_iid", "rounds": 2},
    ]
    return dry, scen


def _same(a: str, b: str):
    assert a.replace("32x8", "16x16") == b


def test_tables_are_the_references():
    tdry, tscen = _rows("32x8")
    rdry, rscen = _rows("16x16")
    _same(treport.dryrun_table(tdry), rreport.dryrun_table(rdry))
    _same(treport.roofline_table(tdry), rreport.roofline_table(rdry))
    assert "qwen2.5-14b" in treport.roofline_table(tdry)
    assert "zamba2-7b" not in treport.roofline_table(tdry)
    _same(treport.scenario_table(tscen), rreport.scenario_table(rscen))
    assert treport.scenario_table([]) == rreport.scenario_table([])
    for x in (0, 3e-7, 2.5e-4, 0.125, 3.2):
        assert treport.fmt_t(x) == rreport.fmt_t(x)
    for x in (12, 3.4e3, 5e6, 7.7e9, 1.2e13):
        assert treport.fmt_b(x) == rreport.fmt_b(x)


def test_main_prints_the_references_report(tmp_path, monkeypatch, capsys):
    for mesh, sub in (("32x8", "port"), ("16x16", "ref")):
        d = tmp_path / sub
        d.mkdir()
        dry, scen = _rows(mesh)
        for i, r in enumerate(dry + scen):
            (d / f"{i:02d}.json").write_text(json.dumps(r))
    treport.main(["--dir", str(tmp_path / "port")])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["report", "--dir",
                                     str(tmp_path / "ref")])
    rreport.main()
    want = capsys.readouterr().out
    _same(got, want)
    assert "## Roofline (single-pod 32x8, calibrated)" in got


def test_main_prints_perf_variants(tmp_path, capsys):
    d = tmp_path / "perf"
    d.mkdir()
    rl = {"t_compute_s": 1e-3, "t_memory_s": 2.0, "t_collective_s": 0.5,
          "bottleneck": "memory", "wall_s": 4.2,
          "wire": {"wire_bytes_round": 3.6e10}}
    (d / "tinyllama-1.1b_train_4k.json").write_text(json.dumps({
        "_pair": "tinyllama-1.1b/train_4k", "flat_fed_compressed": rl,
        "seq_shard": {"refused": "not ported (ROADMAP A17)"}}))
    (tmp_path / "dry").mkdir()
    treport.main(["--dir", str(tmp_path / "dry"), "--perf", str(d)])
    out = capsys.readouterr().out
    assert "## Perf variants (1 pairs" in out
    assert ("| tinyllama-1.1b/train_4k | flat_fed_compressed | 1.0ms | "
            "2.00s | 500.0ms | **memory** | 36.0GB | 4.2s |") in out
    assert "refused: not ported (ROADMAP A17)" in out


@pytest.mark.parametrize("S_,G", [(24, 2), (2048, 1)])
def test_softmax_bf16_is_the_references(S_, G):
    r = np.random.default_rng(S_ + G)
    KV, hd = 2, 8
    q = r.normal(size=(1, S_, KV, G, hd)).astype(np.float32)
    k = r.normal(size=(1, S_, KV, hd)).astype(np.float32)
    v = r.normal(size=(1, S_, KV, hd)).astype(np.float32)
    prev = jattn.SOFTMAX_BF16, tattn.SOFTMAX_BF16
    try:
        jattn.SOFTMAX_BF16 = tattn.SOFTMAX_BF16 = True
        want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True))
        got = tattn._sdpa(*map(torch.from_numpy, (q, k, v))).numpy()
        off = tattn._sdpa(*map(torch.from_numpy, (q, k, v)))
    finally:
        jattn.SOFTMAX_BF16, tattn.SOFTMAX_BF16 = prev
    f32 = tattn._sdpa(*map(torch.from_numpy, (q, k, v))).numpy()
    # one bf16 rounding of the product (8 bits of mantissa) apart
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))
    assert not np.array_equal(off.numpy(), f32)
    np.testing.assert_allclose(got, f32, rtol=0, atol=0.02)
    assert tattn.SOFTMAX_BF16 is False
