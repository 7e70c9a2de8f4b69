"""The PyTorch port stands alone: no file of ``src/repro_torch`` (its
``sharding`` package and the dry run's ``launch`` modules included), not
``chip_smoke.py`` and not the sharded tests' rank workers
(``tests/_torch_dist_worker.py``, ``_torch_tp_worker.py``,
``_torch_tp_train_worker.py``, ``_torch_tp_grad_worker.py``,
``_torch_tp_moe_worker.py``, ``_torch_tp_hybrid_worker.py`` and
``_torch_flat_tp_worker.py``) and not the card probes of the
tensor-parallel phases, ``scripts/tp_probe.py`` and
``scripts/flat_tp_probe.py``, imports ``jax`` or the reference package
``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist_worker.py",
    ROOT / "tests" / "_torch_tp_worker.py",
    ROOT / "tests" / "_torch_tp_train_worker.py",
    ROOT / "tests" / "_torch_tp_grad_worker.py",
    ROOT / "tests" / "_torch_tp_moe_worker.py",
    ROOT / "tests" / "_torch_tp_hybrid_worker.py",
    ROOT / "tests" / "_torch_flat_tp_worker.py",
    ROOT / "scripts" / "tp_probe.py", ROOT / "scripts" / "flat_tp_probe.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _banned(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_port_package_is_complete():
    """Every module of the slices exists beside its reference counterpart,
    and every kernel namespace has its CUDA source."""
    for rel in ("core/flat.py", "core/delta_sgd.py", "core/fed_round.py",
                "core/fed_loop.py", "core/losses.py", "core/client_opt.py",
                "core/server_opt.py", "kernels/delta_sgd/delta_sgd.py",
                "kernels/delta_sgd/ref.py", "kernels/delta_sgd/ops.py",
                "models/small.py",
                "models/common.py", "data/pipeline.py", "data/synthetic.py",
                "data/dirichlet.py", "federation/schedulers.py",
                "configs/paper_tasks.py", "launch/train.py",
                "compression/spec.py", "compression/ops.py",
                "kernels/compress/compress.py", "kernels/compress/ref.py",
                "kernels/robust_agg/robust_agg.py",
                "kernels/robust_agg/ref.py", "federation/heterogeneity.py",
                "federation/faults.py", "federation/scenarios.py",
                "configs/base.py", "configs/tinyllama_1_1b.py",
                "configs/zamba2_7b.py", "models/attention.py",
                "models/ssm.py", "models/transformer.py", "models/model.py",
                "kernels/flash_attention/flash_attention.py",
                "kernels/flash_attention/ref.py",
                "kernels/mamba2_scan/mamba2_scan.py",
                "kernels/mamba2_scan/ops.py", "kernels/mamba2_scan/ref.py",
                "launch/steps.py", "launch/serve.py", "serving/engine.py",
                "kernels/telemetry/telemetry.py", "kernels/telemetry/ref.py",
                "telemetry/__init__.py", "telemetry/spec.py",
                "telemetry/schema.py", "telemetry/events.py",
                "telemetry/spans.py", "telemetry/profiling.py",
                "launch/report.py", "conformance/__init__.py",
                "conformance/kernels.py", "checkpoint/__init__.py",
                "checkpoint/checkpoint.py", "federation/buffer.py",
                "federation/arena.py", "serving/registry.py",
                "serving/personalize.py", "serving/loadgen.py",
                "sharding/spec.py", "sharding/hlo.py", "launch/dryrun.py",
                "launch/mesh.py", "launch/specs.py", "roofline.py",
                "launch/perf.py"):
        assert (ROOT / "src" / "repro" / rel).exists(), rel
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    # the port's own process-group runtime and rank-local round
    for rel in ("sharding/__init__.py", "sharding/dist.py", "core/sharded.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    assert any(p.parent.name == "sharding" for p in PORT_FILES)
    for ns in ("delta_sgd", "compress", "robust_agg", "flash_attention",
               "mamba2_scan", "telemetry"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / ns / "csrc"
                / f"{ns}.cu").exists(), ns
