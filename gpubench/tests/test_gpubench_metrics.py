"""The per-layer metrics' arithmetic against intervals worked out by
hand."""

import importlib.util
import os

import pytest

from gpubench import cells, roofline
from gpubench import trace as tr


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(cells.HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# Two runs in a window [0, 10]: run A [0, 4], run B [4.5, 9].
RECORD = {
    "window": (0.0, 10.0),
    "runs": [
        {"start": 0.0, "end": 4.0, "wall_s": 4.0, "bound_s": {"em_kernel": 0.5},
         "spans": {"read": [(0.0, 1.0)], "scan": [(0.5, 1.5)], "upload": [(1.0, 2.0)],
                   "kernel": [(2.0, 3.0), (2.5, 3.5)], "gather": []}},
        {"start": 4.5, "end": 9.0, "wall_s": 4.5, "bound_s": {"em_kernel": 0.5},
         "spans": {"read": [(4.5, 6.5)], "scan": [], "upload": [(6.0, 7.0)],
                   "kernel": [(7.0, 8.0)], "gather": []}},
    ],
    "device": [("void em_kernel<float, false>(...)", 2.0, 3.5),
               ("Memcpy HtoD", 1.0, 2.0),
               ("void em_kernel<float, false>(...)", 7.0, 8.0),
               ("Memcpy HtoD", 6.0, 7.0),
               ("void em_kernel<float, false>(...)", 9.5, 11.0)],   # cut run, past the end
}


def test_interval_helpers():
    assert tr.merge([(2, 3), (0, 1), (0.5, 1.5)]) == [(0, 1.5), (2, 3)]
    assert tr.length([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert tr.clip([(0, 2), (5, 7), (9, 12)], 1, 10) == [(1, 2), (5, 7), (9, 10)]
    assert tr.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


@pytest.mark.parametrize("name, want", [
    ("read_s", ((1.5 - 0.0) + (6.5 - 4.5)) / 2),          # read and scan, the union
    ("upload_s", (1.0 + 1.0) / 2),
    ("kernel_s", (1.5 + 1.0) / 2),
    ("untraced_s", ((4.0 - 3.5) + (4.5 - 3.5)) / 2),      # wall less the union of all spans
    ("em_roofline", 100.0 * (0.5 + 0.5) / (1.5 + 1.0)),   # the runs' own EM kernels only
    ("device_idle", 100.0 * (1 - (2.5 + 2.0 + 0.5) / 10.0)),  # clipped to the window
])
def test_reader(name, want):
    assert reader(name)(RECORD) == pytest.approx(want, rel=1e-12)


def test_readers_return_nothing_without_data():
    empty = {"window": (0.0, 1.0), "device": [],
             "runs": [{"start": 0.0, "end": 1.0, "wall_s": 1.0, "bound_s": {"em_kernel": 0.1},
                       "spans": {}}]}
    for name in ("read_s", "upload_s", "kernel_s", "em_roofline", "device_idle"):
        assert reader(name)(empty) is None, name


def test_breakdown_names_gaps_by_span():
    b = tr.breakdown(RECORD)
    assert b["device_ops"][0][0].startswith("void em_kernel")
    assert b["device_ops"][0][1] == pytest.approx(1.5 + 1.0 + 0.5)
    gaps = dict((label, s) for label, s in b["idle_gaps"])
    assert gaps["run 0: read+scan"] == pytest.approx(1.0)      # [0, 1]
    assert gaps["run 1: read"] == pytest.approx(2.5)           # [3.5, 6]: its middle in the read
    assert gaps["run 1: no span"] == pytest.approx(1.5)        # [8, 9.5]: 8.75 in run 1
    assert sum(gaps.values()) == pytest.approx(10.0 - 5.0)


def test_em_bound_arithmetic():
    # 2 sites x 3 pairs sampled of 6: steps 0 is a dead lane, 60 counts 49 tests
    steps = [[1, 2, 60], [0, 3, 4]]
    work = roofline.em_work(steps, n_pairs=6, n_rows_live=7)
    assert work == {"live_rows": 7, "live_lanes": 5 * 2.0, "tests": (1 + 2 + 49 + 3 + 4) * 2.0}
    b = roofline.em_bound_s(work, n_sites=2, n_ind=4, itemsize=4, n_matrices=3)
    flop = 49 * 9 * 7 + 2 * 118.0 + 32 * 10.0
    assert b["flop"] == flop and b["bytes"] == 3 * 4 * 2 * 4 + 3 * 6 * 16
    assert b["seconds"] == max(flop / roofline.PEAK_F64, b["bytes"] / roofline.PEAK_BYTES)
