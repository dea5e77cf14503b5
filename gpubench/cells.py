"""A cell of BENCHMARK.json, found by name, and the modules it names.

A cell names a configuration and a traffic mix.  The configuration's
file names its input generator (`"input"`: gpubench/gen/<input>.py); the
traffic file (gpubench/traffic/<traffic>.json) names the program that
serves it (`"program"`: gpubench/programs/<program>.py: the command line
of one run, the entry it calls, the program's spans and counters) and
the semantics its outputs are judged by (`"check"`:
gpubench/checks/<check>.py: the options it implements, the plain
reference, the comparison, the work of an output and its least time on
the card).  The limits of the cell's output check are
gpubench/limits/<cell>.json.  A new kind of job is new files of these
kinds; no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gpubench")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def module(kind: str, name: str):
    """gpubench/<kind>/<name>.py, loaded by its path (a name may hold
    dots) and kept in sys.modules."""
    key = f"gpubench.{kind}.{name}"
    if key not in sys.modules:
        path = os.path.join(HERE, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict      # the configuration's file
    traffic: dict     # the traffic mix's file
    limits: dict      # number compared -> {"limit": ...}, and the "control"
    end_to_end: List[dict]
    per_layer: List[dict]   # the per-layer metrics this cell reports

    @property
    def check(self):
        return module("checks", self.traffic["check"])

    @property
    def program(self):
        return module("programs", self.traffic["program"])

    @property
    def gen(self):
        return module("gen", self.config["input"])

    @property
    def options(self) -> dict:
        return self.check.options(self.traffic["args"])

    def with_traffic(self, **changes) -> "Cell":
        """This cell with keys of its traffic file replaced."""
        return dataclasses.replace(self, traffic={**self.traffic, **changes})


def load(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    m = manifest()
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in m["configs"]}[w["config"]]
    per_layer = [p for p in m["per_layer"] if name in p.get("workloads", [name])]
    e2e = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load(os.path.join(ROOT, cfg["file"])),
                traffic=_load(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=_load(os.path.join(HERE, "limits", f"{name}.json")),
                end_to_end=e2e, per_layer=per_layer)
