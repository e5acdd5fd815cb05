"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole, by the
part before the first dot: ``bendy_tpu_torch`` is not ``bendy_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bendy_tpu"}


def imports(path: Path):
    """(top-level name, level) of every import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def modules(under: Path):
    return sorted(p for p in under.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", modules(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    names = {n for n, level in imports(path) if level == 0}
    assert not names & FORBIDDEN


@pytest.mark.parametrize("path", modules(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_only_itself(path):
    for name, level in imports(path):
        assert name != "bendy_tpu_torch" and name not in FORBIDDEN
        assert level <= 1, "the reference reaches outside its package"
        if level == 0:
            assert name != "benchmark"


def test_top_level_names_are_whole():
    sys.modules.setdefault("bendy_tpu_torch_probe_x", sys)
    try:
        assert "bendy_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["bendy_tpu_torch_probe_x"]
    sys.modules["bendy_tpu.fake"] = sys
    try:
        assert run.forbidden_modules() == ["bendy_tpu"]
    finally:
        del sys.modules["bendy_tpu.fake"]


def test_no_card_no_result():
    """Without a CUDA card the run fails and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "cornell.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=BENCH.parent, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
