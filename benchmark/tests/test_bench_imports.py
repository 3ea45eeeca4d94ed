"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.common import FORBIDDEN_MODULES, forbidden_loaded

from .conftest import ROOT

BENCH = ROOT / "benchmark"


def imported(path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert forbidden_loaded(["mpas_tpu_torch", "mpas_tpu_torch.ops",
                             "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["mpas_tpu.ops", "jax", "jaxlib.xla"]) == [
        "jax", "jaxlib.xla", "mpas_tpu.ops"]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 30
    for f in files:
        assert not imported(f) & set(FORBIDDEN_MODULES), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "mpas_tpu_torch" not in imported(f), f


DRY_RUN = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import common
from benchmark.tests.conftest import small_params, small_traffic
spec = common.load_spec()
for w in {cells!r}:
    cell = common.find(spec["workloads"], w, "w")
    run.run_cell(spec, w, 7, 0.5, 1, torch.device("cpu"),
                 small_params(cell["config"]), small_traffic(w))
print("LOADED", common.forbidden_loaded(sys.modules))
"""


def test_a_dry_run_loads_neither():
    """A traced run of a cell of each configuration on the CPU, in a
    process of its own, holds neither JAX nor the JAX package."""
    cells = ["jw_120km.l26", "ocean_global_120km.analysis"]
    out = subprocess.run(
        [sys.executable, "-c", DRY_RUN.format(root=str(ROOT), cells=cells)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
