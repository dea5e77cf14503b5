"""The program under test for an ngsDist job: the command line of one
run, the entry users call (ngsdist_tpu_torch.cli.main, in process), the
program's spans (utils/profiling.StageTimes, turned on through
profiling.ACTIVE) and the EM entries' launch counters.  The port is
imported inside the functions, once set-up has started."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence


def command(config: dict, traffic: dict, input_path: str, out: str, seed: int,
            platform: str) -> List[str]:
    """The command line of one run of the cell."""
    return ["--geno", input_path, "--n_ind", str(config["n_ind"]),
            "--n_sites", str(config["n_sites"]), *traffic["args"],
            "--seed", str(seed), "--out", out, "--verbose", "1",
            "--platform", platform]


def entry() -> Callable[[Sequence[str]], int]:
    from ngsdist_tpu_torch import cli

    return cli.main


def spans(device):
    """A fresh record of the program's spans: .t0 (perf_counter) and
    .intervals() -> {name: [(start, end)]} relative to it."""
    from ngsdist_tpu_torch.utils import profiling

    return profiling.StageTimes(device)


def activate(record: Optional[object]) -> None:
    """Send the program's spans to `record` (None: off)."""
    from ngsdist_tpu_torch.utils import profiling

    profiling.ACTIVE = record


def counters() -> dict:
    """The EM entries' launch counts: the route the runs took."""
    from ngsdist_tpu_torch.ops import em

    return {k: getattr(em, k) for k in ("LAUNCHES", "LAUNCHES_F64", "BLOCK_LAUNCHES",
                                         "BLOCK_LAUNCHES_F64")}
