"""What the benchmark loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or repkiller_tpu (the program's own name,
repkiller_tpu_torch, begins with the latter and is allowed); and the
plain reference, the comparison and the yardstick load nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

import _tiny  # noqa: F401  (puts the harness on sys.path)
from harness import driver

BENCH = Path(__file__).resolve().parent.parent
YARDSTICK = ["reference", "report", "check", "genomes", "roofline",
             "profile", "manifest"]


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = set(_top_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repkiller_tpu"}, path


def test_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        tops = set(_top_imports(BENCH / "harness" / f"{name}.py"))
        assert "repkiller_tpu_torch" not in tops, name
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.modules['repkiller_tpu_torch'] = None; "
            "sys.modules['repkiller_tpu'] = None; sys.modules['jax'] = None; "
            % str(BENCH)
            + "; ".join(f"import harness.{n}" for n in YARDSTICK)
            + "; import control")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports, the program included, in a fresh process:
    the check the harness makes once its window has closed finds nothing."""
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import run; from harness import driver, job; "
            "import repkiller_tpu_torch.cli; "
            "print(driver.loaded_forbidden())"
            % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["repkiller_tpu_torch_x"] = sys
        assert driver.loaded_forbidden() == []
        sys.modules["jaxlib.xla"] = sys
        assert driver.loaded_forbidden() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_a_card_a_run_prints_no_result():
    """On a machine without CUDA the run exits non-zero and prints nothing
    on standard output."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ecoli_k12_self.ungapped", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
