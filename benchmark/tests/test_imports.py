"""The import guard: nothing of the benchmark imports JAX or the JAX
package, and its yardstick (reference, generators, roofline) imports
nothing of the program, its tests or chip_smoke.  Top-level names are
compared whole: monortm_tpu_torch is not monortm_tpu."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
NEVER = {"jax", "jaxlib", "flax", "monortm_tpu"}
YARDSTICK = NEVER | {"monortm_tpu_torch", "tests", "chip_smoke"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module a file imports, wherever in it."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & NEVER


@pytest.mark.parametrize("sub", ["reference", "gen", "roofline"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    for path in sorted((HERE / sub).rglob("*.py")):
        assert not imported_tops(path) & YARDSTICK, path


REHEARSAL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.tests.tiny import tiny
from benchmark import run as R
for name in json.loads(sys.argv[2]):
    c = tiny(name)
    R.run(c, 2_147_483_647 + 12, 0.5, False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_forbidden_module_after_a_rehearsal_of_each_cell(tmp_path):
    cells = [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    out = subprocess.run([sys.executable, "-c", REHEARSAL, str(ROOT),
                          json.dumps(cells)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "monortm_tpu_torch" in tops
    assert not tops & NEVER
