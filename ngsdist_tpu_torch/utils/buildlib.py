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


def compile_into(path: str, compiler_and_flags: List[str], inputs: List[str],
                 trailing: Sequence[str] = ()) -> None:
    """Run `<compiler_and_flags> -o <temporary> <inputs> <trailing>` and
    rename the result to `path`; raises with the compiler's errors."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [*compiler_and_flags, "-o", tmp, *inputs, *trailing]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log_tmp = f"{tmp}.log"
    with open(log_tmp, "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(log_tmp, path[:-3] + ".log")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
