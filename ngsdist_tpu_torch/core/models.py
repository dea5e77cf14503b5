"""Evolutionary-model corrections applied to the averaged raw distance.

Reference semantics (reference ngsDist.cpp:378-401): model 0 is the
raw p-distance, 1 the additive log transform -log(1-d), 2 JC69; models
3-6 (K80, F81, HKY85/F84, TN93) are accepted by the CLI but abort with
"not yet supported" — reproduced here for drop-in parity.  The names
live in config.EVOL_MODEL_NAMES (parse_args.cpp:41-48).
"""

from __future__ import annotations

import numpy as np

from ..config import NgsDistError

_UNSUPPORTED = {3: "K80", 4: "F81", 5: "HKY85", 6: "TN93"}


def check_model_supported(evol_model: int) -> None:
    if evol_model in _UNSUPPORTED:
        raise NgsDistError("gen_dist", f"{_UNSUPPORTED[evol_model]} model not yet supported")
    if evol_model not in (0, 1, 2):
        raise NgsDistError("gen_dist", "invalid evolutionary model specified!")


def apply_evol_model(d, evol_model: int, xp=np):
    """Transform averaged distances (array or scalar) under `xp` (numpy
    or a module with numpy's `log`).  Operation order matches the C
    expressions so the CPU float64 path agrees with the reference."""
    check_model_supported(evol_model)
    if evol_model == 0:
        return d
    if evol_model == 1:
        return -xp.log(1 - d)
    # JC69: -log(1 - (d * 4/3)) * 3/4 with C's left-associated int promotion
    return -xp.log(1 - (d * 4 / 3)) * 3 / 4
