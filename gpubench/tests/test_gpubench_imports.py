"""Nothing the benchmark runs loads jax or the JAX package, and its
reference loads nothing of the port either: a fresh process drives a
whole run of the harness (on the CPU) or imports the reference, and
then lists every module it holds, compared by whole top-level names
(the port's name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gpubench import cells

HERE = cells.HERE
JAX = ("jax", "jaxlib", "flax", "ngsdist_tpu")

_RUN = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from gpubench import cells, run
m = cells.manifest()
big = cells.load("n1092.boot8")
cell = cells.Cell(name="tiny", chips=1,
                  config={{**big.config, "n_ind": 10, "n_sites": 300}},
                  traffic={{**big.traffic,
                           "args": ["--probs", "--n_boot_rep", "2", "--boot_block_size", "5"]}},
                  limits=big.limits, end_to_end=m["end_to_end"], per_layer=m["per_layer"])
res = run.run_cell(cell, 3, 0.3, {traced}, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"correct": res["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REF = """
import json, sys
sys.path.insert(0, {root!r})
import gpubench.reference.ngsdist, gpubench.reference.taus, gpubench.checks.ngsdist_em
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_loads_neither_jax_nor_the_jax_package(traced):
    got = _modules(_RUN.format(root=cells.ROOT, traced=traced))
    assert got["correct"]
    assert "ngsdist_tpu_torch" in got["modules"]
    assert not set(got["modules"]) & set(JAX)


def test_the_reference_loads_nothing_of_the_port():
    got = _modules(_REF.format(root=cells.ROOT))
    assert not set(got["modules"]) & set(JAX + ("ngsdist_tpu_torch",))


def _sources():
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
                  if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_source_imports(path):
    """No file of the harness names jax or the JAX package in an import;
    only the program modules, the drivers and the tests name the port."""
    banned = set(JAX)
    rel = os.path.relpath(path, HERE)
    if not (rel.startswith(("programs", "tests")) or rel in ("run.py", "control.py")):
        banned.add("ngsdist_tpu_torch")
    for node in ast.walk(ast.parse(open(path).read(), path)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        assert not {n.split(".")[0] for n in names} & banned, (rel, node.lineno, names)
