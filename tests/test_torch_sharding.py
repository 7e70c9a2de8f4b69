"""The port's sharding specs, rules, layouts and recorder checks (pure
Python, no process group).

``repro_torch.sharding.spec`` against ``repro.sharding.spec``: the flat
(C, N) spec of both stock federations on the reference tests' duck-typed
production meshes, and the parameter rules for every arch's param tree
(the reference's PartitionSpec entries normalised: jax 0.9 stores a
one-axis tuple as the bare name). ``layout_of(shards=S)`` pads and
offsets as the reference's does; ``local_slab`` and ``gather_slab`` are
inverses; the collective recorder's checks flag what the reference's
HLO checks flag; ``arena_shardings`` places what the reference's
NamedShardings place; the ``static`` event's collective fields.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.core import flat as rflat
from repro.models import build_model
from repro.sharding import spec as rspec
from repro_torch.core import flat as tflat
from repro_torch.federation.arena import (arena_init, arena_local,
                                          arena_shardings)
from repro_torch.sharding import hlo
from repro_torch.sharding import spec as tspec


class FakeMesh:
    """Duck-typed mesh: only .shape (dict) is read by the rules."""
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "test": {"data": 2, "model": 2},
}
KINDS = ("cross_device", "cross_silo")


def _entry(e):
    """A spec entry as a tuple of axis names (None -> ())."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _norm(ps):
    return tuple(_entry(e) for e in ps)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_flat_spec_matches_reference(mesh_id, kind):
    mesh = FakeMesh(MESHES[mesh_id])
    r = rspec.get_federation_spec(kind, mesh)
    t = tspec.get_federation_spec(kind, mesh)
    assert (t.client_axes, t.fsdp_axes, t.tp_axes) == (
        r.client_axes, r.fsdp_axes, r.tp_axes)
    assert t.flat_axes(mesh) == r.flat_axes(mesh)
    assert _norm(t.flat_spec(mesh)) == _norm(r.flat_spec(mesh))
    assert _norm([t.flat_client_spec(mesh)]) == _norm(
        r.flat_client_spec(mesh))
    assert t.flat_shards(mesh) == r.flat_shards(mesh)
    assert t.clients_on(mesh) == r.clients_on(mesh)


def _param_leaves(arch):
    cfg = get_config(arch)
    shapes = jax.eval_shape(build_model(cfg, jnp.bfloat16).init,
                            jax.random.key(0))
    return [(rspec._path_str(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]


SPECS = {
    "cross_device_tp": dict(client_axes=("data",), fsdp_axes=(),
                            tp_axes=("model",)),
    "cross_silo": dict(client_axes=("pod",), fsdp_axes=("data",),
                       tp_axes=("model",)),
    "expert_2d": dict(client_axes=("pod",), fsdp_axes=("data",),
                      tp_axes=("model",), expert_2d=True),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_match_reference(arch):
    """param_pspec, _resolve_conditional and _dedupe leaf by leaf, for
    three specs on both production meshes."""
    leaves = _param_leaves(arch)
    for fields in SPECS.values():
        r, t = rspec.FederationSpec(**fields), tspec.FederationSpec(**fields)
        for mesh_id in ("single", "multi"):
            mesh = FakeMesh(MESHES[mesh_id])
            for path, leaf in leaves:
                rp = rspec.param_pspec(r, path, leaf)
                tp = tspec.param_pspec(t, path, leaf)
                assert _norm(tp) == _norm(rp), (path, fields)
                rres = rspec._dedupe(rspec._resolve_conditional(
                    rp, leaf.shape, mesh, "model"))
                tres = tspec.param_axes(t, mesh, path, leaf.shape)
                assert _norm(tres) == _norm(rres), (path, fields, mesh_id)


def test_dedupe_and_conditionals():
    assert tspec._dedupe(("model", "model")) == ("model", None)
    assert tspec._dedupe((("pod", "data"), "data")) == (("pod", "data"),
                                                        None)
    mesh = FakeMesh(MESHES["multi"])
    assert tspec._resolve_conditional(("kv", "heads_t", "e2d"),
                                      (32, 8, 512), mesh, "model") == (
        "model", None, ("model", "data"))
    assert tspec._resolve_conditional(("e2d",), (64,), mesh,
                                      "model") == (None,)


def _tree(rng):
    return {"emb": rng.normal(size=(33, 7)).astype(np.float32),
            "w": rng.normal(size=(129,)).astype(np.float32),
            "b": rng.normal(size=(5, 3, 2)).astype(np.float32),
            "big": rng.normal(size=(3000, 41)).astype(np.float32)}


@pytest.mark.parametrize("shards", [1, 2, 4, 16, 256])
def test_layout_matches_reference(shards):
    tree = _tree(np.random.default_rng(0))
    r = rflat.layout_of(jax.tree.map(jnp.asarray, tree), shards=shards)
    t = tflat.layout_of({k: torch.from_numpy(v) for k, v in tree.items()},
                        shards=shards)
    assert (t.size, t.padded_size, t.shards) == (r.size, r.padded_size,
                                                 r.shards)
    assert [(s.offset, s.size, tuple(s.shape)) for s in t.leaves] == [
        (s.offset, s.size, tuple(s.shape)) for s in r.leaves]
    per = t.padded_size // shards
    assert t.padded_size % shards == 0 and per % tflat.LANES == 0
    # the cache key includes the shard count
    assert tflat.layout_of({k: torch.from_numpy(v)
                            for k, v in tree.items()}, shards=shards) is t


def test_layout_refuses_shards_below_one():
    with pytest.raises(ValueError, match="shards must be >= 1"):
        tflat.layout_of({"x": torch.zeros(3)}, shards=0)


def _coords(shape):
    names = list(shape)
    for idx in np.ndindex(*shape.values()):
        yield dict(zip(names, idx))


@pytest.mark.parametrize("mesh_id,kind", [
    ("test", "cross_device"), ("test", "cross_silo"),
    ("multi_small", "cross_device"), ("multi_small", "cross_silo")])
def test_local_slab_and_gather_slab_are_inverses(mesh_id, kind):
    shape = (MESHES["test"] if mesh_id == "test"
             else {"pod": 2, "data": 2, "model": 2})
    mesh = FakeMesh(shape)
    fed = tspec.get_federation_spec(kind, mesh)
    nc = fed.clients_on(mesh)
    C, N = 4 * nc, 128 * fed.flat_shards(mesh) * 3
    buf = torch.arange(C * N, dtype=torch.float32).view(C, N)
    vec = torch.arange(N, dtype=torch.float32)
    blocks, vblocks = {}, {}
    for c in _coords(shape):
        blk = tflat.local_slab(buf, mesh, fed, c)
        assert blk.is_contiguous()
        assert tuple(blk.shape) == fed.local_shape(mesh, C, N)
        blocks[tuple(c.values())] = blk
        vblocks[tuple(c.values())] = tflat.local_slab(vec, mesh, fed, c)
    assert torch.equal(tflat.gather_slab(blocks, mesh, fed), buf)
    assert torch.equal(tflat.gather_slab(vblocks, mesh, fed), vec)
    # blocked row-major over the client axes, in the axes' order
    ca, na = fed.flat_axes(mesh)
    c0 = {a: 0 for a in shape}
    if ca:
        last = dict(c0, **{a: shape[a] - 1 for a in ca})
        assert torch.equal(tflat.local_clients(buf, mesh, fed, last),
                           buf[C - 4:])
    if nc > 1:
        with pytest.raises(ValueError, match="do not split"):
            tflat.local_clients(buf[:C - 1], mesh, fed, c0)


def test_local_shape_refuses_uneven_splits():
    mesh = FakeMesh(MESHES["test"])
    fed = tspec.get_federation_spec("cross_device", mesh)
    assert fed.local_shape(mesh, 8, 256) == (4, 128)
    with pytest.raises(ValueError, match="must divide the 2 client shards"):
        fed.local_shape(mesh, 7, 256)
    with pytest.raises(ValueError, match="does not split over 2 N shards"):
        fed.local_shape(mesh, 8, 255)


def _op(kind, shape, axes, dtype="float32", op="sum", group=2):
    n = int(np.prod(shape))
    return hlo.CollectiveOp(kind, n * 4, group, axes, dtype, shape, op)


def test_recorder_checks_have_teeth():
    """A client-crossing (C_loc, N_loc) f32 payload is flagged, the same
    payload within one client coordinate (over the N-shard axes) is not;
    a (C, N) payload is flagged whatever its axes; the bound tightens."""
    mesh = FakeMesh(MESHES["test"])
    fed = tspec.get_federation_spec("cross_device", mesh)
    C, N = 8, 1024
    slab = _op("all-gather", (4, 512), ("data",))
    intra = _op("all-gather", (4, 1024), ("model",))
    agg = _op("all-reduce", (512 + 5,), ("data",))
    ok = [intra, agg, _op("all-reduce", (2, 4), ("model",))]
    assert hlo.assert_no_fullprec_delta_collective(
        ok, C, N, mesh=mesh, federation=fed)["fullprec"] == 0
    with pytest.raises(AssertionError, match="crossed the client shard"):
        hlo.assert_no_fullprec_delta_collective(ok + [slab], C, N,
                                                mesh=mesh, federation=fed)
    with pytest.raises(AssertionError, match="crossed the client shard"):
        hlo.assert_no_fullprec_delta_collective(
            ok, C, N, mesh=mesh, federation=fed, max_payload_elems=100)
    with pytest.raises(ValueError, match="max_payload_elems"):
        hlo.assert_no_fullprec_delta_collective(
            ok, C, N, mesh=mesh, federation=fed, max_payload_elems=0)
    with pytest.raises(ValueError, match=">= 2 clients per"):
        hlo.assert_no_fullprec_delta_collective(ok, 2, N, mesh=mesh,
                                                federation=fed)
    # an int payload is not a full-precision delta
    assert hlo.fullprec_collective_report(
        [_op("all-gather", (4, 512), ("data",), dtype="int8")],
        max_elems=4 * 512, client_axes=("data",))["fullprec"] == 0
    assert hlo.assert_flat_buffer_sharded(ok + [slab], C, N)[
        "full_shape"] == 0
    with pytest.raises(AssertionError, match="global"):
        hlo.assert_flat_buffer_sharded([_op("all-gather", (8, 1024),
                                            ("model",))], C, N)
    assert hlo.assert_peak_below_global(3 * C * N * 4 - 1, C, N)
    with pytest.raises(AssertionError, match="not below"):
        hlo.assert_peak_below_global(3 * C * N * 4, C, N)


def test_peak_bound_counts_local_slabs():
    """A rank's peak is bounded by its own (C_loc, N_loc) slabs: five
    pass a six-slab bound, and an extra full-width (C_loc, N) row block
    (two more local slabs at S = 2) fails it, though it stays below the
    three global slabs. The checks raise under ``python -O`` too."""
    import subprocess
    import sys
    C, N, S = 4, 1024, 2
    c_loc, n_loc = C // 2, N // S
    slab = c_loc * n_loc * 4
    rep = hlo.assert_peak_within_local(5 * slab, c_loc, n_loc, slabs=6)
    assert rep["local_slabs"] == 5.0 and rep["local_bound_bytes"] == 6 * slab
    wide = 5 * slab + c_loc * N * 4
    assert hlo.assert_peak_below_global(wide, C, N)
    with pytest.raises(AssertionError, match="exceeds 6 local"):
        hlo.assert_peak_within_local(wide, c_loc, n_loc, slabs=6)
    code = ("from repro_torch.sharding import hlo\n"
            "try:\n"
            "    hlo.assert_peak_within_local(10, 1, 1, slabs=2)\n"
            "except AssertionError:\n"
            "    print('raised')\n")
    out = subprocess.run([sys.executable, "-O", "-c", code],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "raised"


def test_wire_bytes_follow_the_reference_ring_rule():
    from repro.roofline import CollectiveOp as ROp
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for n in (1, 2, 4, 256):
            assert hlo.CollectiveOp(kind, 4096, n).wire_bytes == ROp(
                kind, 4096, n).wire_bytes


def test_recorder_log_and_summary():
    hlo.reset()
    hlo.record(_op("all-reduce", (10,), ("data",)))
    hlo.record(_op("all-gather", (2, 8), ("model",)))
    ops = hlo.snapshot()
    hlo.reset()
    assert len(ops) == 2 and hlo.snapshot() == []
    s = hlo.summary(ops, rounds=2)
    assert s["collective_count"] == 2 and s["collectives_per_round"] == 1
    assert s["collective_bytes"] == 4 * 26
    assert s["collective_kinds"] == ["all-gather", "all-reduce"]
    assert s["collective_wire_bytes"] == pytest.approx(40 + 32)


def test_static_telemetry_reads_the_recorder():
    from repro_torch.telemetry.profiling import static_telemetry
    plain = static_telemetry(rounds=2, launches={"delta_sgd/x": 4})
    assert "collective_count" not in plain
    ops = [_op("all-reduce", (10,), ("data",))] * 4
    row = static_telemetry(rounds=2, launches={"delta_sgd/x": 4},
                           collectives=ops)
    for k in ("collective_count", "collectives_per_round",
              "collective_bytes", "collective_bytes_per_round",
              "collective_wire_bytes", "collective_kinds"):
        assert k in row
    assert row["collectives_per_round"] == 2


def test_run_metadata_records_the_mesh():
    from repro_torch.telemetry.events import run_metadata
    assert run_metadata(device="cpu")["mesh"] is None
    assert run_metadata(mesh=FakeMesh({"data": 2, "model": 2}),
                        device="cpu")["mesh"] == {"data": 2, "model": 2}


@pytest.mark.parametrize("kind", KINDS)
def test_arena_shardings_match_reference(kind):
    from repro.federation.arena import arena_init as r_arena_init
    from repro.federation.arena import arena_shardings as r_shardings
    rmesh = jax.make_mesh((2, 2), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2,
                          devices=jax.devices()[:4])
    mesh = FakeMesh(MESHES["test"])
    rfed = rspec.get_federation_spec(kind, rmesh)
    tfed = tspec.get_federation_spec(kind, mesh)
    r = r_shardings(r_arena_init(8, eta0=0.1, ef_width=256), rmesh, rfed)
    ar = arena_init(8, eta0=0.1, ef_width=256)
    t = arena_shardings(ar, mesh, tfed)
    for rs, ts in zip(r, t):
        assert _norm(ts) == _norm(tuple(rs.spec))
    # a rank's rows: blocked over the client axes
    rows = arena_local(ar._replace(eta=torch.arange(8.0)), mesh, tfed,
                       {"data": 1, "model": 0})
    want = (torch.arange(4.0, 8.0) if kind == "cross_device"
            else torch.arange(8.0))
    assert torch.equal(rows.eta, want) and rows.ef.shape[1] == 256
