"""The port's serving path on the CPU: ``DecodeEngine`` against the
reference's with the same parameters (``repro_torch.interop``) and the
same prompts (and, for Whisper, the same stub frames a request) — the
same greedy tokens and the same
``history`` of slot groups and occupancy — with fewer slots than
requests, ``flush_tokens``
that does not divide the generation length, and a sliding window with a
rolling cache. Where the reference's top-2 logit margin at a generated
position is under 1e-4, the tie could go either way on another backend:
the test says so and compares that sequence only up to there. Also: one
device-to-host copy per flush, the kernels' launch counts per request,
and the CLI with every serving flag (a watched or pinned checkpoint
dir, the load generator, personalization, events). The reference's
margins come from one jitted replay per (arch, shape)."""
import functools
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving.engine import greedy_decode as jgreedy_decode
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.serving import DecodeEngine
from repro_torch.serving.engine import greedy_decode

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 500
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: its ops are small,
    and eight threads a worker contend with the other test workers and
    with XLA's pool in the same process. Put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(arch, layers):
    jcfg = jget_config(arch).reduced(num_layers=layers, vocab=VOCAB)
    jmodel = jbuild_model(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.key(3)))
    model = build_model(get_config(arch).reduced(num_layers=layers,
                                                 vocab=VOCAB))
    return jmodel, jparams, model, interop.params_from_numpy(jparams)


@functools.lru_cache(maxsize=None)
def _replay(arch, layers, cache_len, window):
    """The reference's prefill and teacher-forced decode steps as one
    jitted call, compiled once per (arch, shape): (params, batch, the
    generated tokens but the last (n,)) -> logits at each generated
    position (n + 1, V)."""
    jmodel = _pair(arch, layers)[0]

    def replay(jparams, batch, toks):
        logits, cache = jmodel.prefill(jparams, batch, cache_len=cache_len,
                                       window=window)

        def body(cache, tok):
            lg, cache = jmodel.decode_step(jparams, cache,
                                           tok.reshape(1, 1), window=window)
            return cache, lg[0, -1]

        _, rows = jax.lax.scan(body, cache, toks)
        return jnp.concatenate([logits[0, -1:], rows])

    return jax.jit(replay)


def _margins(arch, layers, prompt, gen, cache_len, window, extras):
    """The reference's top-2 logit margin at each generated position,
    replaying the sequence through its prefill and decode steps."""
    jparams = _pair(arch, layers)[1]
    batch = {k: jnp.asarray(v[None])
             for k, v in {"tokens": prompt, **(extras or {})}.items()}
    rows = _replay(arch, layers, cache_len, window)(
        jparams, batch, jnp.asarray(gen[:-1], jnp.int32))
    top2 = np.sort(np.asarray(rows), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _serve_both(arch, layers, *, n_req, prompt_len, gen, slots, flush,
                window=None, cache_len=None):
    jmodel, jparams, model, params = _pair(arch, layers)
    cache_len = cache_len or (prompt_len + gen
                              + model.cfg.num_image_tokens)
    rng = np.random.default_rng(n_req)
    prompts = rng.integers(0, VOCAB, (n_req, prompt_len)).astype(np.int32)
    extras = [serve._row_extras(model.cfg, rng) for _ in prompts]
    out = []
    for Engine, m, p in ((JDecodeEngine, jmodel, jparams),
                         (DecodeEngine, model, params)):
        eng = Engine(m, p, slots=slots, cache_len=cache_len,
                     flush_tokens=flush, window=window)
        rids = [eng.submit(pr, gen, extras=ex)
                for pr, ex in zip(prompts, extras)]
        done = {c.request_id: np.asarray(c.tokens)
                for c in eng.run_until_idle()}
        out.append((eng, [done[r] for r in rids]))
    (jeng, jtoks), (eng, toks) = out
    for i, (a, b) in enumerate(zip(jtoks, toks)):
        assert a.shape == b.shape == (gen,)
        near = np.flatnonzero(_margins(arch, layers, prompts[i], a,
                                       cache_len, window, extras[i])
                              < MARGIN)
        upto = int(near[0]) if near.size else gen
        if upto < gen:
            warnings.warn(f"request {i}: top-2 margin < {MARGIN} at "
                          f"generated position {upto}; tokens compared "
                          f"only before it")
        np.testing.assert_array_equal(b[:upto], a[:upto])
    return jeng, eng


def _history(h):
    return [(r["groups"], r["occupancy"], r["tokens"]) for r in h]


@pytest.mark.parametrize("arch,layers,n_req,slots,flush,gen", [
    ("tinyllama-1.1b", 2, 5, 2, 3, 8),      # slots < requests, 3 ∤ 8
    ("zamba2-7b", 7, 4, 3, 4, 6),           # Zamba2 with its shared block
    ("whisper-tiny", 2, 3, 2, 3, 6),        # frames, the enc_kv pool
])
def test_engine_matches_the_reference(arch, layers, n_req, slots, flush,
                                      gen):
    jeng, eng = _serve_both(arch, layers, n_req=n_req, prompt_len=12,
                            gen=gen, slots=slots, flush=flush)
    assert _history(eng.history) == _history(jeng.history)
    m, jm = eng.metrics(), jeng.metrics()
    for k in ("serve_tokens_total", "serve_occupancy_mean",
              "requests_completed"):
        assert m[k] == jm[k], k


def test_engine_with_a_rolling_window_matches_the_reference():
    """--window 12 over prompt 10 + gen 9 with --roll-cache: the cache
    holds 12 entries and rolls as a ring buffer."""
    jeng, eng = _serve_both("tinyllama-1.1b", 2, n_req=3, prompt_len=10,
                            gen=9, slots=2, flush=4, window=12, cache_len=12)
    assert _history(eng.history) == _history(jeng.history)


def test_single_token_requests_complete_at_admission():
    jeng, eng = _serve_both("tinyllama-1.1b", 2, n_req=3, prompt_len=6,
                            gen=1, slots=2, flush=4)
    assert _history(eng.history) == _history(jeng.history)
    assert eng.stats["completed"] == 3


def test_greedy_decode_matches_the_reference():
    jmodel, jparams, model, params = _pair("zamba2-7b", 7)
    toks = np.random.default_rng(0).integers(0, VOCAB, (2, 9)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            cache_len=16)
    jt0 = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    jout, _, _ = jgreedy_decode(jmodel, jax.tree.map(jnp.asarray, jparams),
                                jc, jt0, 6)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  cache_len=16)
    out, _, _ = greedy_decode(model, params, cache,
                              torch.argmax(logits[:, -1:], -1), 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_one_device_to_host_copy_per_flush(monkeypatch):
    """The host reads each flush's tokens (and the first tokens of the
    requests it admitted) in one copy, and reads nothing else."""
    _, _, model, params = _pair("tinyllama-1.1b", 2)
    eng = DecodeEngine(model, params, slots=2, cache_len=20, flush_tokens=3)
    prompts = np.random.default_rng(1).integers(0, VOCAB, (3, 8))
    for pr in prompts:
        eng.submit(pr, 7)
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: copies.append(1)
                        or cpu(self, *a, **k))

    def refuse(self, *a, **k):
        raise AssertionError("the engine read a tensor on the host")

    for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    while eng.has_work():
        before = len(copies)
        eng.step()
        assert len(copies) - before == 1
    monkeypatch.undo()
    assert eng.stats["completed"] == 3


@pytest.mark.parametrize("arch,layers,attn_sites,ssd_sites", [
    ("tinyllama-1.1b", 2, 2, 0), ("zamba2-7b", 14, 2, 12)])
def test_prefill_runs_each_kernel_once_per_site_and_decode_none(
        arch, layers, attn_sites, ssd_sites):
    _, _, model, params = _pair(arch, layers)
    eng = DecodeEngine(model, params, slots=2, cache_len=16, flush_tokens=4)
    for pr in np.random.default_rng(2).integers(0, VOCAB, (3, 8)):
        eng.submit(pr, 8)
    fa.reset_launch_count()
    m2.reset_launch_count()
    eng.run_until_idle()
    assert fa.LAUNCHES == {("flash_attention", "cpu"): 3 * attn_sites}
    assert m2.launch_count() == m2.launch_count("cpu") == 3 * ssd_sites
    assert eng.stats["flushes"] == 4      # 2 + 1 requests, 2 flushes each


def test_submit_refuses_a_request_longer_than_the_cache():
    _, _, model, params = _pair("tinyllama-1.1b", 2)
    eng = DecodeEngine(model, params, slots=1, cache_len=10)
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(np.zeros(8, np.int32), 3)
    with pytest.raises(ValueError, match=r"\(S,\)"):
        eng.submit(np.zeros((1, 4), np.int32), 3)


# --------------------------------------------------------------------- CLI
def _args(*extra):
    return serve.build_parser().parse_args(
        ["--device", "cpu", "--arch", "tinyllama-1.1b", "--reduced",
         "--batch", "2", "--prompt-len", "16", "--gen", "8", *extra])


def test_cli_serves_on_the_cpu_and_defaults_to_the_card():
    out = serve.run(_args())
    assert out["tokens"].shape == (2, 8) and out["tokens"].dtype == np.int32
    assert out["tok_per_s"] > 0
    assert out["metrics"]["requests_completed"] == 2
    again = serve.run(_args())
    np.testing.assert_array_equal(again["tokens"], out["tokens"])
    assert serve.build_parser().parse_args(
        ["--arch", "zamba2-7b"]).device == "cuda"


def test_cli_window_needs_roll_cache_like_the_reference():
    with pytest.raises(SystemExit, match="--roll-cache"):
        serve.run(_args("--window", "12"))
    out = serve.run(_args("--window", "12", "--roll-cache", "--slots", "1"))
    assert out["tokens"].shape == (2, 8)
    assert [h["occupancy"] for h in out["history"]] == [1.0] * 2


def _ckpt(d):
    """A training-style checkpoint of the CLI's reduced TinyLlama (its
    own init at seed 0, scaled) at steps 3 and 5 in ``d``."""
    from repro_torch.checkpoint import save
    from repro_torch.utils.tree import tree_map
    model = build_model(get_config("tinyllama-1.1b").reduced(),
                        torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    for step in (3, 5):
        save(d, {"params": tree_map(lambda p: p * (step / 4), params),
                 "round": step}, step=step)
    return model


def _demo_after_deltas(model, d, flags, k):
    """The demo tokens the CLI must decode after drawing ``k`` deltas
    from the demo's stream (the reference's draw order)."""
    from repro_torch.checkpoint import restore_params
    args = _args(*flags)
    params = model.init(torch.Generator().manual_seed(0))
    if args.ckpt_dir:
        params, _ = restore_params(args.ckpt_dir, params,
                                   step=args.ckpt_step)
    rng = np.random.default_rng(args.seed)
    n = serve.PersonalizationStore(params).layout.padded_size
    for _ in range(k):
        rng.normal(scale=1e-3, size=(n,))
    return serve.demo(serve.make_engine(model, params, args), args, rng)[0]


# each flag combination the port once refused, now served: the flags,
# whether the checkpoint dir is watched, the load-gen requests, deltas
@pytest.mark.parametrize("flags,watched,loadgen,deltas", [
    (["--ckpt-dir", "D", "--loadgen", "4"], True, 4, 0),
    (["--ckpt-dir", "D", "--ckpt-step", "3", "--personalize", "2"],
     False, 0, 2),
    (["--loadgen", "4"], False, 4, 0),
    (["--arrival", "closed"], False, 0, 0),
    (["--rate", "5"], False, 0, 0),
    (["--personalize", "2"], False, 0, 2),
    (["--events", "E"], False, 0, 0),
    (["--loadgen", "4", "--arrival", "closed", "--personalize", "2"],
     False, 4, 2),
    (["--loadgen", "3", "--rate", "5", "--events", "E"], False, 3, 0)],
    ids=["ckpt-loadgen", "pinned-personalize", "loadgen", "closed", "rate",
         "personalize", "events", "closed-loadgen-personalize",
         "rate-loadgen-events"])
def test_cli_serving_flags_run(flags, watched, loadgen, deltas, tmp_path,
                               monkeypatch):
    """A watched --ckpt-dir polls its dir once at start-up and once a
    flush (a pinned --ckpt-step never); --loadgen N completes N requests
    first, on the same engine; --personalize K draws K deltas from the
    demo's stream before its prompts; --events writes a header, one
    serve_flush row a flush and one serve_load row a load run; the demo
    decodes the tokens of a plain engine on the same params."""
    from repro_torch.serving import ModelRegistry
    from repro_torch.telemetry import load_events
    d, ev = str(tmp_path / "ck"), str(tmp_path / "e.jsonl")
    flags = [{"D": d, "E": ev}.get(f, f) for f in flags]
    model = _ckpt(d)
    polls = []
    poll = ModelRegistry.poll
    monkeypatch.setattr(ModelRegistry, "poll",
                        lambda self: polls.append(1) or poll(self))
    out = serve.run(_args(*flags))
    assert out["ckpt_step"] == (None if "--ckpt-dir" not in flags else
                                3 if "--ckpt-step" in flags else 5)
    flushes = len(out["history"])
    assert len(polls) == ((flushes + 1) if watched else 0)
    assert {h["version"] for h in out["history"]} == {out["ckpt_step"] or 0}
    assert out["metrics"]["serve_swaps_total"] == 0
    np.testing.assert_array_equal(
        out["tokens"], _demo_after_deltas(model, d, flags, deltas))
    if loadgen:
        rep = out["report"]
        assert rep["requests"] == loadgen
        assert rep["p99_s"] >= rep["p50_s"] > 0
        assert 0 < rep["occupancy"] <= 1 and rep["tok_per_s"] > 0
        assert out["metrics"]["requests_completed"] == loadgen + 2
    else:
        assert out["report"] is None
    if "--events" in flags:
        header, rows = load_events(ev)
        assert header["config"] == {"arch": "tinyllama-1.1b",
                                    "mode": "serve", "slots": 2,
                                    "flush_tokens": 8}
        kinds = [r["kind"] for r in rows]
        assert kinds.count("serve_flush") == flushes
        assert kinds.count("serve_load") == (1 if loadgen else 0)


def test_cli_serves_params_from_a_checkpoint(tmp_path):
    """--ckpt-dir loads the params of a training-style checkpoint
    (``params/...`` keys beside a round counter): the saved init decodes
    the in-memory run's tokens, a pinned --ckpt-step of changed params
    decodes others, and another model's checkpoint is refused."""
    from repro_torch.checkpoint import save
    from repro_torch.utils.tree import tree_map
    model = build_model(get_config("tinyllama-1.1b").reduced(),
                        torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    d = str(tmp_path)
    save(d, {"params": params, "round": 3}, step=3)
    save(d, {"params": tree_map(lambda p: p * 1.5, params), "round": 5},
         step=5)
    mem = serve.run(_args())
    got = serve.run(_args("--ckpt-dir", d, "--ckpt-step", "3"))
    assert got["ckpt_step"] == 3 and mem["ckpt_step"] is None
    np.testing.assert_array_equal(got["tokens"], mem["tokens"])
    newest = serve.run(_args("--ckpt-dir", d))
    assert newest["ckpt_step"] == 5
    assert not np.array_equal(newest["tokens"], mem["tokens"])
    with pytest.raises(KeyError, match="not in checkpoint step 5"):
        serve.run(serve.build_parser().parse_args(
            ["--device", "cpu", "--arch", "zamba2-7b", "--reduced",
             "--batch", "2", "--prompt-len", "16", "--gen", "8",
             "--ckpt-dir", d]))


def test_cli_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "zamba2-7b", "--reduced", "--batch", "2", "--prompt-len",
         "16", "--gen", "8"], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "decoded 8 tokens x 2 on cpu" in proc.stdout
