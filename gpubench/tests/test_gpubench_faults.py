"""The check that decides `correct` fails what it must: the control (the
reference in bfloat16 in the program's place) and a run whose timed path
is broken underneath.  The runs skip the harness's look for a card and
drive the rest of a run (gpubench/run.py run_cell) on the CPU at a tiny
size, held to the limits of n1092.boot8.

Faults this system's cells can have, each planted in the program: a
bootstrap replicate that returns the full data's state (its site weights
left out), half the sites left out of the EM with the mean taken over
the rest, and one individual's distances altered where a matrix is made.
One card drives each cell, so there is no exchange between chips to
leave out."""

import time

import numpy as np
import pytest
import torch

from gpubench import cells, control, run

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def weighted_route(monkeypatch):
    """The cells' bootstrap route, weighted recompute: at this size the
    block partials would fit the budget for the partial-sum route."""
    from ngsdist_tpu_torch.core import distance

    monkeypatch.setattr(distance, "PARTIALS_BUDGET_BYTES", 0)


def _run(cell, seconds=0.6):
    return run.run_cell(cell, 2**31 + 5, seconds, False, CPU, time.perf_counter())


def test_sound_run_is_correct(tiny_cell):
    res = _run(tiny_cell())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"run_s", "updates_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_a_window_that_cuts_the_first_run_judges_it(tiny_cell):
    res = _run(tiny_cell(), seconds=0.01)
    assert res["correct"] and res["attempted"] == 1
    assert "run_s" not in res["metrics"]


def test_traced_run_reads_the_spans(tiny_cell):
    res = run.run_cell(tiny_cell(), 11, 0.6, True, CPU, time.perf_counter())
    assert res["correct"]
    assert {"read_s", "kernel_s", "untraced_s"} <= set(res["metrics"])
    assert res["device"]["window_s"] >= 0.6 and "breakdown" in res


def test_replicate_returns_the_full_data_state(tiny_cell, monkeypatch):
    from ngsdist_tpu_torch.core import distance

    monkeypatch.setattr(distance, "replicate_weights",
                        lambda site_map, n_trunc: np.ones(n_trunc))
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["d_err"]["value"] > 1e-3


def test_half_the_sites_left_out(tiny_cell, monkeypatch):
    from ngsdist_tpu_torch.core import distance

    real = distance.em_raw_cnt

    def half(P, score9, pairwise_del, site_weights=None, site_index=None, tiles=None):
        keep = torch.arange(0, P.shape[0], 2, device=P.device)
        w = None if site_weights is None else torch.as_tensor(site_weights)[keep.cpu()]
        raw, cnt = real(P[keep], score9, pairwise_del, w, None, tiles)
        return raw * (P.shape[0] / keep.numel()), cnt * (P.shape[0] / keep.numel())

    monkeypatch.setattr(distance, "em_raw_cnt", half)
    res = _run(tiny_cell())
    assert not res["correct"]


def test_an_answer_altered_where_it_is_made(tiny_cell, monkeypatch):
    from ngsdist_tpu_torch.core import distance

    real = distance._finalize
    made = []

    def altered(raw, cnt, pars, on_stats=None):
        d = real(raw, cnt, pars, on_stats)
        made.append(1)
        if len(made) % 4 == 3:             # the second replicate of every run
            d[5, :5] += 1e-3
            d[:5, 5] += 1e-3
        return d

    monkeypatch.setattr(distance, "_finalize", altered)
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["d_err"]["value"] > 5e-4


def test_failed_run_is_not_correct(tiny_cell, monkeypatch):
    from ngsdist_tpu_torch.io import writers

    def broken(fh, labels, m):
        raise OSError("disk full")

    calls = []
    real = writers.write_dist_matrix

    def fails_later(fh, labels, m):
        calls.append(1)
        return (real if len(calls) <= 4 else broken)(fh, labels, m)   # warm-up passes

    monkeypatch.setattr(writers, "write_dist_matrix", fails_later)
    res = _run(tiny_cell())
    assert not res["correct"] and res["failed"] == 1


@pytest.mark.parametrize("name", ["n1092.boot8", "n179.boot4"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limit(tiny_cell, seed, name):
    """The control of the float32 cells, the reference with its inputs
    and EM in bfloat16, put in the program's place and judged by the
    harness's own check at 48 individuals over 2,000 sites: `correct`
    false, d_err well past the limit."""
    cell = tiny_cell(n_ind=48, n_sites=2000)
    cell.limits = cells.load(name).limits
    (ctl, entry), = control.controls(cell, seed, CPU).values()
    res = run.run_cell(ctl, seed, 0.01, False, CPU, time.perf_counter(), entry=entry,
                       warm_up=False)
    assert not res["correct"]
    assert res["checks"]["d_err"]["value"] > 10 * cell.limits["d_err"]["limit"]
    assert res["checks"]["bad_matrices"]["value"] == 0


def test_control_takes_the_programs_place(tiny_cell):
    """The control writes what the program writes: the same runs, every
    matrix in the phylip format, judged like the program's."""
    cell = tiny_cell(n_ind=20, n_sites=500)
    entry = cell.check.control(cell.config, cell.options, 9, torch.float64, CPU)
    res = run.run_cell(cell, 9, 0.3, False, CPU, time.perf_counter(), entry=entry)
    assert res["correct"] and res["attempted"] >= 2
    assert res["checks"]["d_err"]["value"] <= 5.0001e-11   # float64: the print alone


def test_program_control_drops_the_precision_flag(tiny_cell):
    cell = tiny_cell(args=("--probs", "--n_boot_rep", "2", "--boot_block_size", "5", "--x64"))
    cell.limits = cells.load("n1092.boot8_x64").limits
    (ctl, entry), = control.controls(cell, 1, CPU).values()
    assert entry is None and "--x64" not in ctl.traffic["args"]
    assert ctl.limits is cell.limits and "--x64" in cell.traffic["args"]
