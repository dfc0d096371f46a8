"""What the benchmark may import and read: no JAX and no JAX package
anywhere under benchmark/ (top-level names compared whole, so the port,
`oramacore_tpu_torch`, passes); nothing of the program in the reference;
none of the JAX package's benchmark files."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "oramacore_tpu"}
OLD_FILES = ("bench.py", "benches/", "BENCH_", "MULTICHIP_", "chip_smoke")


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_top_level_names_compared_whole():
    assert "oramacore_tpu_torch".split(".")[0] not in BANNED
    assert "oramacore_tpu.index".split(".")[0] in BANNED


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(top_imports(path)) & BANNED
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("name", ["reference.py", "check.py", "roofline.py",
                                  "corpus.py", "traffic.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    found = {m for m in top_imports(BENCH / name)
             if m.startswith("oramacore")}
    assert not found, f"{name} imports {found}"


def string_literals(tree):
    """String constants of the code, docstrings left out."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr):
            docs.add(id(node.body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize(
    "path", [p for p in sources() if p.parent.name != "tests"],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_none_of_the_jax_benchmark_files(path):
    for text in string_literals(ast.parse(path.read_text())):
        for old in OLD_FILES:
            assert old not in text, f"{path} names {old}: {text[:80]}"


def test_only_system_imports_the_program():
    users = {p.name for p in sources() if p.parent == BENCH
             and "oramacore_tpu_torch" in set(top_imports(p))}
    assert users == {"system.py"}
