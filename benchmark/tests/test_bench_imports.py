"""No file of the benchmark imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
plain reference imports nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sisr_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "sisr_tpu_torch" not in set(_imports(path)), path


def test_the_scan_sees_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import sisr_tpu_torch.infer\nfrom sisr_tpu.models import x\n"
                     "import jaxtyping\n")
    assert FORBIDDEN & set(_imports(probe)) == {"sisr_tpu"}
