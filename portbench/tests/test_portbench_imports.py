"""What the benchmark may import and read."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "openrec_tpu"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "openrec_tpu_torch" not in imported(path)


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_reads_none_of_the_jax_benchmarks(path):
    text = path.read_text()
    for name in ("benchmarks/", "bench.py", "BENCH_", "BASELINE",
                 "MULTICHIP_"):
        assert name not in text


def test_the_port_is_not_the_jax_package():
    from portbench.harness import FORBIDDEN, forbidden_modules
    assert "openrec_tpu_torch".split(".")[0] not in FORBIDDEN
    import sys
    sys.modules["openrec_tpu.fake_for_test"] = object()
    try:
        assert "openrec_tpu.fake_for_test" in forbidden_modules()
    finally:
        del sys.modules["openrec_tpu.fake_for_test"]
    assert not [m for m in forbidden_modules()
                if m.startswith("openrec_tpu_torch")]
