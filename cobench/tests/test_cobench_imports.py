"""Nothing under cobench/ imports JAX, the JAX package or the root's
bench.py, or names a file of the JAX package.  Top-level module names are
compared whole: `cocircom_tpu_torch`, the port, begins with
`cocircom_tpu`, the JAX package, and is allowed."""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cocircom_tpu", "bench"}
SOURCES = sorted(ROOT.rglob("*.py"))
JAX_DIR = "cocircom_tpu" + "/"     # a path into the JAX package, spelled so it is not one
ROOT_BENCH = "bench" + ".py"


def imported_tops(tree) -> set:
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_the_check_compares_whole_names():
    tree = ast.parse("import cocircom_tpu_torch.ops\nfrom cocircom_tpu.ops import x\n")
    assert imported_tops(tree) & FORBIDDEN == {"cocircom_tpu"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_or_file(path):
    tree = ast.parse(path.read_text())
    assert not imported_tops(tree) & FORBIDDEN
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert JAX_DIR not in node.value and not node.value.endswith(ROOT_BENCH)


def test_the_harness_loads_neither_when_imported():
    import cobench.manifest  # noqa: F401
    import cobench.reference.groth16  # noqa: F401
    import cobench.run  # noqa: F401

    assert not {m.split(".")[0] for m in sys.modules} & (FORBIDDEN - {"bench"})
