"""The readers of the program's fetch, matrix and write spans against a
record worked out by hand."""

import pytest

from gpubench import cells

# Two runs: A [0, 4] with overlapping fetches, B [5, 9]; the cut run's
# spans do not count.
RECORD = {
    "window": (0.0, 10.0),
    "device": [],
    "runs": [
        {"start": 0.0, "end": 4.0, "wall_s": 4.0, "bound_s": {},
         "spans": {"read": [(0.0, 1.0)], "fetch": [(1.0, 2.0), (1.5, 2.5)],
                   "matrix": [(2.5, 3.0)], "write": [(3.0, 3.25), (3.5, 3.75)]}},
        {"start": 5.0, "end": 9.0, "wall_s": 4.0, "bound_s": {},
         "spans": {"fetch": [(5.0, 5.5)], "matrix": [(6.0, 7.0), (7.5, 8.0)],
                   "write": [(8.0, 9.0)]}},
    ],
    "cut": [{"start": 9.0, "end": 10.5, "wall_s": 1.5, "bound_s": {},
             "spans": {"fetch": [(9.0, 10.0)], "matrix": [], "write": []}}],
}


def reader(name):
    return cells.module("metrics", name).read


@pytest.mark.parametrize("name, want", [
    ("fetch_s", ((2.5 - 1.0) + 0.5) / 2),      # the union of A's overlapping fetches
    ("matrix_s", (0.5 + (1.0 + 0.5)) / 2),
    ("write_s", ((0.25 + 0.25) + 1.0) / 2),
])
def test_span_reader(name, want):
    assert reader(name)(RECORD) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name, span", [("fetch_s", "fetch"), ("matrix_s", "matrix"),
                                        ("write_s", "write")])
def test_span_reader_finds_nothing_without_its_span(name, span):
    """A program without the span (the parent of the change that added
    it) reads None, whatever its other spans hold."""
    runs = [{**r, "spans": {k: v for k, v in r["spans"].items() if k != span}}
            for r in RECORD["runs"]]
    assert reader(name)({**RECORD, "runs": runs}) is None
    empty = [{**r, "spans": {**r["spans"], span: []}} for r in RECORD["runs"]]
    assert reader(name)({**RECORD, "runs": empty}) is None
    assert reader(name)({**RECORD, "runs": []}) is None
