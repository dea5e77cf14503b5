"""Build-at-first-use of the port's shared libraries (the native host
runtime, utils/native.py, and the CUDA kernels, ops/_build.py).

A library lives in `ngsdist_tpu_torch/_build/` under a name that carries
a hash of its sources and flags, so a stale library is never loaded.  It
is compiled under a name of the building process's own and renamed into
place: a process that finds the final name finds a whole file, and
several processes building at once each rename an identical library.
The compiler's output is kept beside the library as `<name>.log`.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def hashed_path(stem: str, flags: Sequence[str], sources: Sequence[str]) -> str:
    """BUILD_DIR/<stem>_<hash of flags and sources>.so"""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def compile_into(path: str, compiler_and_flags: List[str], sources: List[str],
                 libs: Sequence[str] = ()) -> None:
    """Build the shared library `path`: every source compiled to an object
    by a compiler process of its own (`<compiler_and_flags> -c`), all
    started together, then one link (`<compiler> -shared <objects>
    <libs>`) under a temporary name, renamed into place.  The log beside
    the library holds every command's output; raises with the first
    failure's errors."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    cmds = [[*compiler_and_flags, "-c", "-o", obj, src] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    runs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(cmds, procs)]
    if all(rc == 0 for *_, rc in runs):
        link = [compiler_and_flags[0], "-shared", "-o", tmp, *objs, *libs]
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.stdout + proc.stderr, proc.returncode))
    with open(f"{tmp}.log", "w") as fh:
        fh.write("".join(" ".join(cmd) + "\n" + out for cmd, out, _ in runs))
    os.replace(f"{tmp}.log", path[:-3] + ".log")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    failed = [(cmd, out, rc) for cmd, out, rc in runs if rc != 0]
    if failed:
        if os.path.exists(tmp):
            os.remove(tmp)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed (rc {rc}):\n{out[-4000:]}")
    os.replace(tmp, path)
