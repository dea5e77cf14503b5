"""Extended evolutionary models: K80, F81, HKY85/F84, TN93.

The reference CLI accepts --evol_model 3..6 and demands a --pos file
with alleles, but aborts with "not yet supported"
(the reference's ngsDist.cpp:387-398; names parse_args.cpp:41-48).
Here they are implemented for the batched engine (the exact engine keeps
the reference's abort for drop-in parity): the batched engine splits
the expected-mismatch sufficient statistics by substitution class —
sites whose two alleles are both purines or both pyrimidines contribute
to the transition proportions (A<->G as P1, C<->T as P2), mixed sites to
the transversion proportion Q — via the engines' existing site-weight
masks, and estimates per-pair base frequencies from expected allele
dosages.  The distance formulas follow the standard pairwise-distance
literature (Kimura 1980; Felsenstein 1981/1984; Tamura & Nei 1993, as
in ape::dist.dna): at equal base frequencies F81 reduces to JC69 and
F84/TN93 reduce to K80 (property-tested).

Sites whose alleles cannot be classified (missing/identical/non-ACGT
letters) are excluded from models >= 3 entirely (they can contribute to
neither P nor Q).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import NgsDistError

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3,
         "0": 0, "1": 1, "2": 2, "3": 3}  # ANGSD numeric coding
_PURINE = (0, 2)  # A, G


def encode_alleles(pos_rows: List[List[str]]) -> Tuple[np.ndarray, np.ndarray]:
    """Allele codes (A=0,C=1,G=2,T=3 or the equivalent ANGSD numeric
    coding 0-3; -1 invalid) from POS rows with at least 4 columns:
    chr, pos, allele1, allele2 (README.md:53)."""
    S = len(pos_rows)
    a1 = np.full(S, -1, np.int8)
    a2 = np.full(S, -1, np.int8)
    for s, row in enumerate(pos_rows):
        if len(row) < 4:
            raise NgsDistError(
                "main", "evolutionary models need allele info in the POS file!"
            )
        a1[s] = _BASE.get(row[2].strip().upper(), -1)
        a2[s] = _BASE.get(row[3].strip().upper(), -1)
    return a1, a2


def classify_sites(a1: np.ndarray, a2: np.ndarray) -> Dict[str, np.ndarray]:
    """Float64 {0,1} site masks by substitution class.

    'ag'/'ct': purine / pyrimidine transitions; 'tv': transversions;
    'ok': any classifiable site (the union)."""
    valid = (a1 >= 0) & (a2 >= 0) & (a1 != a2)
    p1 = np.isin(a1, _PURINE)
    p2 = np.isin(a2, _PURINE)
    ts = valid & (p1 == p2)
    ag = ts & p1
    ct = ts & ~p1
    tv = valid & (p1 != p2)
    f = lambda m: m.astype(np.float64)  # noqa: E731
    return {"ag": f(ag), "ct": f(ct), "tv": f(tv), "ok": f(valid)}


def expected_base_counts(P: np.ndarray, a1: np.ndarray, a2: np.ndarray) -> np.ndarray:
    """[S, N, 4] expected allele counts per individual per site: each
    individual carries 2 alleles; the expected dosage of allele2 is
    P1 + 2*P2 (genotype = count of allele2), the rest is allele1."""
    S, N, _ = P.shape
    d2 = P[..., 1] + 2.0 * P[..., 2]        # [S, N]
    d1 = 2.0 - d2
    bc = np.zeros((S, N, 4), np.float64)
    ok = (a1 >= 0) & (a2 >= 0)
    # scatter by allele code (vectorized per base letter)
    for b in range(4):
        m1 = ok & (a1 == b)
        m2 = ok & (a2 == b)
        bc[m1, :, b] += d1[m1]
        bc[m2, :, b] += d2[m2]
    return bc


# ------------------------- distance formulas ------------------------ #


def _safe_log(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(x)


def _sdiv(a, b):
    """a/b with 0 where b <= 0 — degenerate base compositions make some
    model terms 0*log(0/0); the correct limit is a vanishing term."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(b > 0, a / np.where(b > 0, b, 1.0), 0.0)


def k80(Pp: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Kimura 1980: d = -1/2 ln(1-2P-Q) - 1/4 ln(1-2Q)."""
    return -0.5 * _safe_log(1 - 2 * Pp - Q) - 0.25 * _safe_log(1 - 2 * Q)


def f81(p: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Felsenstein 1981: d = -E ln(1 - p/E), E = 1 - sum(pi^2).

    E = 0 (composition concentrated on one base) makes p/E = 0/0; the
    correct limit is a vanishing distance, handled by _sdiv."""
    E = 1.0 - np.sum(pi ** 2, axis=-1)
    return -E * _safe_log(1 - _sdiv(p, E))


def f84(Pp: np.ndarray, Q: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Felsenstein 1984 (the reference's "HKY85/F84" slot,
    parse_args.cpp:47): ape::dist.dna F84 formula."""
    piA, piC, piG, piT = (pi[..., i] for i in range(4))
    piR = piA + piG
    piY = piC + piT
    A = _sdiv(piC * piT, piY) + _sdiv(piA * piG, piR)
    B = piC * piT + piA * piG
    C = piR * piY
    d = -2 * A * _safe_log(1 - _sdiv(Pp, 2 * A) - _sdiv((A - B) * Q, 2 * A * C))
    d = d + 2 * (A - B - C) * _safe_log(1 - _sdiv(Q, 2 * C))
    return d


def tn93(P1: np.ndarray, P2: np.ndarray, Q: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """Tamura & Nei 1993 with distinct purine/pyrimidine transition
    proportions P1 (A<->G), P2 (C<->T)."""
    piA, piC, piG, piT = (pi[..., i] for i in range(4))
    piR = piA + piG
    piY = piC + piT
    k1 = 2 * _sdiv(piA * piG, piR)
    k2 = 2 * _sdiv(piC * piT, piY)
    k3 = 2 * (piR * piY - _sdiv(piA * piG * piY, piR) - _sdiv(piC * piT * piR, piY))
    w1 = 1 - _sdiv(P1, k1) - _sdiv(Q, 2 * piR)
    w2 = 1 - _sdiv(P2, k2) - _sdiv(Q, 2 * piY)
    w3 = 1 - _sdiv(Q, 2 * piR * piY)
    return -k1 * _safe_log(w1) - k2 * _safe_log(w2) - k3 * _safe_log(w3)


def apply_extended_model(
    evol_model: int,
    raw_ag: np.ndarray,
    raw_ct: np.ndarray,
    raw_tv: np.ndarray,
    cnt: np.ndarray,
    pi: Optional[np.ndarray],
) -> np.ndarray:
    """Distance matrix from class-split sufficient statistics.

    raw_* are per-pair expected mismatches restricted to each class of
    sites; cnt the per-pair classifiable-site denominators; pi [.., 4]
    per-pair base frequencies (models 4-6)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        P1 = raw_ag / cnt
        P2 = raw_ct / cnt
        Q = raw_tv / cnt
        if evol_model == 3:
            return k80(P1 + P2, Q)
        if evol_model == 4:
            return f81(P1 + P2 + Q, pi)
        if evol_model == 5:
            return f84(P1 + P2, Q, pi)
        if evol_model == 6:
            return tn93(P1, P2, Q, pi)
    raise NgsDistError("gen_dist", "invalid evolutionary model specified!")
