"""Host-side replay of the reference's hot loop for its debug dump.

The port's matrices come from core/distance.py; at verbose >= 8 the
reference also prints a line per (pair, site), which `debug_site_dump`
replays on the host in the reference's exact operation order
(reference ngsDist.cpp:325-404), with the per-site EM delegated to the
native runtime (ngsdist_native.c: nd_em2_site_run).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import native as _native


def to_ind_major(P_site_major: np.ndarray) -> np.ndarray:
    """[n_sites, n_ind, 3] -> contiguous [n_ind, n_sites, 3] for the
    pair-loop engine's cache behavior."""
    return np.ascontiguousarray(P_site_major.transpose(1, 0, 2))


def debug_site_dump(
    P_ind_major: np.ndarray,
    score: np.ndarray,
    indep: bool,
    pairwise_del: bool,
    labels,
    verbose: int,
    site_map: Optional[np.ndarray] = None,
    n_used: Optional[int] = None,
    fh=None,
) -> None:
    """Per-site debug firehose of the reference hot loop at verbose>=8:
    the cumulative-distance line per (pair, site) and, at verbose>=9,
    the per-genotype-combination terms (ngsDist.cpp:355-360).  Python
    reproduces the C accumulation order exactly (C doubles), with the
    per-site EM delegated to the native nd_em2_site, so the printed
    values match the reference character-for-character."""
    import sys

    fh = fh if fh is not None else sys.stderr
    lib = _native.get_lib()
    n_ind, n_sites, _ = P_ind_major.shape
    if n_used is None:
        n_used = n_sites if site_map is None else len(site_map)
    sites = site_map if site_map is not None else np.arange(n_used)
    P = P_ind_major
    uniform = np.full(9, 1.0 / 9.0)

    def miss(p):  # miss_data (gen_func.cpp:862-868)
        return abs(p[0] - p[1]) < 1e-5 and abs(p[1] - p[2]) < 1e-5

    for i1 in range(n_ind):
        for i2 in range(i1 + 1, n_ind):
            dist = 0.0
            cnt = 0
            for t in range(n_used):
                s = int(sites[t])
                p1 = P[i1, s]
                p2 = P[i2, s]
                if pairwise_del and (miss(p1) or miss(p2)):
                    continue
                sfs = uniform.copy()
                if not indep:
                    lib.nd_em2_site_run(
                        _native.as_double_ptr(sfs),
                        _native.as_double_ptr(np.ascontiguousarray(p1)),
                        _native.as_double_ptr(np.ascontiguousarray(p2)),
                    )
                for g1 in range(3):
                    for g2 in range(3):
                        w = p1[g1] * p2[g2]
                        dist += score[g1, g2] * (w if indep else sfs[3 * g1 + g2])
                        if verbose >= 9:
                            # ngsDist.cpp:355-356 ("%lu\t%lu <-> %lu\t...")
                            fh.write(
                                f"{t}\t{i1} <-> {i2}\t{g1} - {g2}\t"
                                f"{w:f}\t{sfs[3 * g1 + g2]:f}\n"
                            )
                if verbose >= 8:
                    # ngsDist.cpp:359-360
                    fh.write(
                        f"Cumulative distance between {labels[i1]} (ind {i1}) "
                        f"and {labels[i2]} (ind {i2}) at site {t}: {dist:f}\n"
                    )
                cnt += 1
            if verbose >= 3:
                # the pair's stats line interleaves with its site dump
                # exactly as in the reference worker (ngsDist.cpp:366-367)
                fh.write(
                    f"\tDistance of {dist:f} from {cnt} valid sites "
                    f"({dist / cnt if cnt else float('nan'):f}) between "
                    f"{labels[i1]} (ind {i1}) and {labels[i2]} (ind {i2})!\n"
                )
