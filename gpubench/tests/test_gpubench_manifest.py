"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, traffic mix, limit and per-layer metric it names resolves
by name to a file of its own under gpubench/."""

import json
import os
import re

import pytest

from gpubench import cells

M = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# widths the contract forbids to cut; for this system: the shape of a record
WIDTHS = ("n_ind", "depth_range", "error_rate")


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert M["paths"] == ["gpubench"] and M["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    cells_n = len(M["workloads"])
    assert 1 <= cells_n <= 24
    # a full check at the largest benchmark later PRs may grow to fits 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    named = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    for group in (M["configs"], M["workloads"], M["end_to_end"] + M["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    lines = [e[k] for e in named for k in ("why", "layer") if k in e]
    lines += [c["source"] for c in M["configs"]] + M["command"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/")
        cfg = json.load(open(os.path.join(cells.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert not set(c["reduced"]) & set(WIDTHS)
        assert any(w["config"] == c["name"] for w in M["workloads"])
    assert len({c["source"] for c in M["configs"]}) == len(M["configs"])
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(cells.HERE, "metrics", f"{m['name']}.py"))
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_by_name(name):
    w = next(w for w in M["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cell = cells.load(name)
    opts = cell.options
    assert opts["n_boot_rep"] > 0 and opts["probs"]
    assert cell.limits["d_err"]["limit"] > 0 and cell.limits["bad_matrices"]["limit"] == 0
    assert cell.limits["control"]["kind"] in ("reference", "program")
    for fn in ("options", "work_per_output", "outputs_in_prefix", "reference_state",
               "bound_s", "judge", "control"):
        assert callable(getattr(cell.check, fn))
    for fn in ("command", "entry", "spans", "activate", "counters"):
        assert callable(getattr(cell.program, fn))
    assert callable(cell.gen.write)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer


def test_one_pair_of_config_and_traffic_each():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
