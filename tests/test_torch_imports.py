"""Import hygiene of the PyTorch/CUDA port: no module of tony_tpu_torch, and
not chip_smoke.py, imports jax or anything of the JAX package. Read from
the source with ``ast`` (not ``sys.modules``: the interpreter may have
imported jax before any test runs)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "tony_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for want in ("tony_tpu_torch/serve/engine.py",
                 "tony_tpu_torch/ops/decode_attention.py", "chip_smoke.py"):
        assert want in names
    assert (ROOT / "tony_tpu_torch/csrc/paged_decode_attention.cu").exists()
