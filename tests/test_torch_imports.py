"""Import hygiene of the PyTorch/CUDA port: no module of tony_tpu_torch, not
chip_smoke.py, not the card's test file, not the gloo ranks' runner
(tests/torch_ranks.py), not scripts/torch_kernel_ab.py and not
scripts/torch_phase14.py imports jax or anything of the JAX package. Read from
the source with ``ast`` (not ``sys.modules``: the interpreter may have
imported jax before any test runs)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
# the card's tests run where JAX is not installed, so their file is held
# to the same rule
FILES = sorted((ROOT / "tony_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests/test_torch_kernels_cuda.py",
    ROOT / "tests/torch_ranks.py", ROOT / "scripts/torch_kernel_ab.py",
    ROOT / "scripts/torch_phase14.py"]


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
                 "tests/test_torch_kernels_cuda.py", "tests/torch_ranks.py"):
        assert want in names
    for src in ("paged_decode_attention", "flash_attention", "grouped_mm", "quant_mm",
                "fused_ce", "overlap"):
        assert (ROOT / f"tony_tpu_torch/csrc/{src}.cu").exists()
