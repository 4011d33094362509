"""Nothing the harness or the reference runs loads JAX, Flax or the JAX
package (top-level names compared whole: ``repro_torch`` is the program),
and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from bench.tests.cells import ROOT

BENCH = Path(ROOT) / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "src")])
    env.pop("JAX_PLATFORMS", None)
    return env


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_top_imports(path)) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not {"repro_torch", "bench"} & set(_top_imports(path)), path


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, json\n"
        "from bench.tests.cells import run_small\n"
        "from bench.lib.harness import forbidden_modules\n"
        "for cell in ('command-r-35b.decode', 'hymba-1.5b.train'):\n"
        "    assert run_small(cell)['correct']\n"
        "print(json.dumps({'bad': forbidden_modules(),"
        " 'torch_port': 'repro_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line == '{"bad": [], "torch_port": true}', line


def test_the_reference_alone_loads_nothing_of_the_program():
    code = (
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('ref', 'bench/reference/decoder.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'repro_torch', 'repro', 'jax', 'bench'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_entry_point_refuses_without_a_card():
    code = ("import torch, runpy, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'command-r-35b.decode', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('bench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == "", (out.returncode, out.stdout)
