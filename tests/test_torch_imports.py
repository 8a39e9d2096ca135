"""Import hygiene of the PyTorch/CUDA port: no module of tony_tpu_torch, not
chip_smoke.py, not the card's test file, not the gloo ranks' runner
(tests/torch_ranks.py), not scripts/torch_kernel_ab.py, not
scripts/torch_phase14.py, 15 or 16 and not the job example's train.py imports jax or
anything of the JAX package. Read from the source with ``ast`` (not
``sys.modules``: the interpreter may have imported jax before any test
runs)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# the card's tests run where JAX is not installed, so their file is held
# to the same rule
FILES = sorted((ROOT / "tony_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests/test_torch_kernels_cuda.py",
    ROOT / "tests/torch_ranks.py", ROOT / "scripts/torch_kernel_ab.py",
    ROOT / "scripts/torch_phase14.py", ROOT / "scripts/torch_phase15.py",
    ROOT / "scripts/torch_phase16.py",
    ROOT / "examples/llama_pretrain_torch/train.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tony_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _banned(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_is_checked():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for want in ("tony_tpu_torch/serve/engine.py", "tony_tpu_torch/serve/spec.py",
                 "tony_tpu_torch/ops/decode_attention.py",
                 "tony_tpu_torch/ops/attention.py", "tony_tpu_torch/ops/fused_ce.py",
                 "tony_tpu_torch/obs/metrics.py", "tony_tpu_torch/train/trainer.py",
                 "tony_tpu_torch/train/loop.py", "tony_tpu_torch/train/data.py",
                 "tony_tpu_torch/train/prefetch.py",
                 "tony_tpu_torch/train/checkpoint.py",
                 "tony_tpu_torch/ops/grouped_mm.py", "tony_tpu_torch/parallel/moe.py",
                 "tony_tpu_torch/parallel/__init__.py", "tony_tpu_torch/ops/quant_mm.py",
                 "tony_tpu_torch/parallel/dist.py", "tony_tpu_torch/parallel/mesh.py",
                 "tony_tpu_torch/parallel/sharding.py", "tony_tpu_torch/ops/overlap.py",
                 "tony_tpu_torch/ops/moe_overlap.py",
                 "tony_tpu_torch/parallel/ring_attention.py",
                 "tony_tpu_torch/parallel/ulysses.py",
                 "tony_tpu_torch/parallel/pipeline.py",
                 "tony_tpu_torch/models/convert.py", "chip_smoke.py",
                 "tests/test_torch_kernels_cuda.py", "tests/torch_ranks.py",
                 # the control plane and the job's example
                 "tony_tpu_torch/utils/net.py", "tony_tpu_torch/utils/proc.py",
                 "tony_tpu_torch/config/config.py", "tony_tpu_torch/config/keys.py",
                 "tony_tpu_torch/rpc/service.py", "tony_tpu_torch/rpc/auth.py",
                 "tony_tpu_torch/rpc/tony_pb2.py", "tony_tpu_torch/chaos/faults.py",
                 "tony_tpu_torch/cluster/__init__.py", "tony_tpu_torch/cluster/backend.py",
                 "tony_tpu_torch/cluster/lease.py", "tony_tpu_torch/cluster/local.py",
                 "tony_tpu_torch/am/events.py", "tony_tpu_torch/am/session.py",
                 "tony_tpu_torch/am/scheduler.py", "tony_tpu_torch/am/app_master.py",
                 "tony_tpu_torch/runtime/base.py", "tony_tpu_torch/runtime/frameworks.py",
                 "tony_tpu_torch/runtime/horovod_driver.py",
                 "tony_tpu_torch/runtime/torch_dist.py",
                 "tony_tpu_torch/executor/task_executor.py",
                 "tony_tpu_torch/executor/__main__.py", "tony_tpu_torch/obs/reporter.py",
                 "tony_tpu_torch/cli/client.py", "tony_tpu_torch/cli/main.py",
                 "tony_tpu_torch/cli/__main__.py",
                 "examples/llama_pretrain_torch/train.py"):
        assert want in names
    for src in ("paged_decode_attention", "flash_attention", "grouped_mm", "quant_mm",
                "fused_ce", "overlap"):
        assert (ROOT / f"tony_tpu_torch/csrc/{src}.cu").exists()
