"""No module a run loads has the top-level name of JAX or of the JAX
package (compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest
from portbench_cells import ROOT

from portbench import bench

JAX_PACKAGE = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu"


def test_top_level_names_compare_whole():
    assert bench.forbidden_loaded([bench.PORT, bench.PORT + ".serve.daemon", "jaxtyping",
                                   "numpy"]) == []
    assert bench.forbidden_loaded([JAX_PACKAGE + ".serve", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["flax", "jax", "jaxlib", JAX_PACKAGE]


def test_a_whole_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "from portbench_cells import tiny\n"
        "from portbench import bench, run\n"
        "line = run.run_cell('build.zipf100k.default', 5, 0.5, False, device='cpu',"
        " t0=time.monotonic(), cell=tiny('build.zipf100k.default'))\n"
        "assert line['correct']\n"
        "print(sorted(bench.forbidden_loaded()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch"}


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    assert not set(_imports(path)) & set(bench.FORBIDDEN)
