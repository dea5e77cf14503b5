"""The port stands alone: `ngsdist_tpu_torch`, `chip_smoke.py`,
`profile_em_parts.py`, `profile_indep_parts.py` and `profile_hmm_parts.py`
import torch and numpy, never jax and nothing of the JAX package
`ngsdist_tpu`."""

import ast
import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import DATA_DIR, FIXTURES, REPO_ROOT

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
PKG = os.path.join(REPO_ROOT, "ngsdist_tpu_torch")
SCRIPTS = [os.path.join(REPO_ROOT, name)
           for name in ("chip_smoke.py", "profile_em_parts.py", "profile_indep_parts.py",
                        "profile_hmm_parts.py")]


def _sources():
    out = list(SCRIPTS)
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "ngsdist_tpu")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    offenders = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        offenders += [f"{path}:{node.lineno}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_port_has_its_own_host_layer():
    """Every module the port used to import from the JAX package has a
    counterpart of the same name in the port."""
    for rel in ("config.py", "version.py", "utils/native.py", "utils/rng.py",
                "utils/signals.py", "utils/checkpoint.py", "utils/profiling.py",
                "utils/hostmem.py",
                "core/bootstrap.py", "core/models.py", "core/preprocess.py",
                "core/exact.py", "core/submodels.py", "io/readers.py", "io/writers.py",
                "csrc/host/ngsdist_native.c", "csrc/host/taus.h"):
        assert os.path.exists(os.path.join(PKG, rel)), rel


_PROBE = """
import json, sys
import ngsdist_tpu_torch
from ngsdist_tpu_torch.cli import main
rc = main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ngsdist_tpu"))
print(json.dumps({"rc": rc, "bad": bad}))
"""


@pytest.mark.parametrize("name", ["GL_pdel", "GP_b3B10", "T_b5B7"])
def test_cli_process_loads_neither_jax_nor_the_jax_package(name, tmp_path):
    """One CLI call on a fixture in a fresh process (readers, bootstrap
    stream, native runtime, writer): the golden bytes, and no module of
    jax or of ngsdist_tpu in sys.modules afterwards.  -S keeps the
    interpreter's site hooks from importing anything first."""
    out = str(tmp_path / "x.dist")
    args = [a.replace("{OUT}", out) for a in MANIFEST[name]["args"]]
    site = [p for p in sys.path if p.endswith("site-packages")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO_ROOT, *site]))
    proc = subprocess.run(
        [sys.executable, "-S", "-c", _PROBE, *args, "--platform", "cpu", "--verbose", "0"],
        cwd=DATA_DIR, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "bad": []}
    assert hashlib.md5(open(out, "rb").read()).hexdigest() == MANIFEST[name]["md5"]
