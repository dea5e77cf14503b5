"""The program under test for an ngsDist job on called genotypes: the
command line, the entry and the spans of programs/ngsdist_cli.py, and
the counters that show the route of --call_geno: the fused codes
reader's reads and sites (io/readers.py read_geno_codes), and the launch
counts of the indep entries and of the EM's, which a called job must not
reach.  The port is imported inside the functions, once set-up has
started."""

from __future__ import annotations

from typing import Callable, Sequence

from gpubench.programs import ngsdist_cli
from gpubench.programs.ngsdist_cli import activate, command, spans  # noqa: F401

_INDEP = ("LAUNCHES", "BLOCK_LAUNCHES", "TILE_LAUNCHES", "LAUNCHES_F64",
          "BLOCK_LAUNCHES_F64", "TILE_LAUNCHES_F64")
_EM = ("LAUNCHES", "LAUNCHES_F64", "BLOCK_LAUNCHES", "BLOCK_LAUNCHES_F64")


def entry() -> Callable[[Sequence[str]], int]:
    """ngsdist_tpu_torch.cli.main; a port without the counters that show
    the route fails here, before set-up."""
    counters()
    return ngsdist_cli.entry()


def counters() -> dict:
    """The codes reader's counts and the indep and EM entries' launch
    counts: the route the runs took."""
    from ngsdist_tpu_torch.io import readers
    from ngsdist_tpu_torch.ops import em, indep

    out = {k: getattr(readers, k) for k in ("CODED_READS", "CODED_ROWS")}
    out.update({f"indep.{k}": getattr(indep, k) for k in _INDEP})
    out.update({f"em.{k}": getattr(em, k) for k in _EM})
    return out
