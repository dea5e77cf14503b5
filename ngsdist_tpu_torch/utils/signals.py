"""Graceful-shutdown signal handling.

The reference ships a 3-strikes SIGINT/SIGTERM/SIGQUIT/SIGPIPE handler
(reference shared/gen_func.cpp:21-52) that its main never arms —
dormant code.  Here the same contract is provided *armed on request*:
the first signal asks the replicate stream to stop after the current
matrix (output stays valid and resumable via utils/checkpoint); the
third forces immediate exit, like the reference's handler would.
"""

from __future__ import annotations

import signal
import sys
from typing import List

_strikes = 0
_requested = False
_armed: List[int] = []


def stop_requested() -> bool:
    return _requested


def _handler(signum, frame):
    global _strikes, _requested
    _strikes += 1
    _requested = True
    name = signal.Signals(signum).name
    if _strikes >= 3:
        print(f"\n=====\nERROR: {name} received thrice; exiting!\n=====\n",
              file=sys.stderr)
        sys.exit(-1)
    print(
        f"\n=====\nWARNING: {name} received; finishing current matrix "
        f"({3 - _strikes} more to force exit)\n=====\n",
        file=sys.stderr,
    )


def arm() -> None:
    """Install the handler (idempotent)."""
    global _strikes, _requested
    if _armed:
        return
    _strikes = 0
    _requested = False
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGQUIT):
        signal.signal(sig, _handler)
        _armed.append(sig)


def disarm() -> None:
    global _requested, _strikes
    for sig in _armed:
        signal.signal(sig, signal.SIG_DFL)
    _armed.clear()
    _requested = False
    _strikes = 0
