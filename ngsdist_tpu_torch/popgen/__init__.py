"""Popgen toolkit on PyTorch.

Port of ngsdist_tpu/popgen: the reference's shared/ directory carries
library components used by sibling ngsTools projects but not linked into
ngsDist itself (SURVEY.md §2.2): an inbreeding/IBD HMM engine, per-site
allele-frequency EM, two-site haplotype-frequency EM, and a bounded
quasi-Newton optimizer.  Each works on a whole batch at once: the EMs
over sites or site pairs as tensor operations, the HMM's per-site scans
over a batch of chains in one kernel launch on a card (csrc/hmm.cu), so
thousands of chains over chromosome-length site axes run as one device
computation.
"""

from .freqs import calc_hwe, est_maf, est_maf_sites, haplo_freq  # noqa: F401
from .hmm import (  # noqa: F401
    calc_emission,
    calc_emission_ld,
    calc_emission_two_mafs,
    joint_geno_prob,
    forward,
    backward,
    posterior_decode,
    transition_matrices,
    viterbi,
)
from .optim import lbfgsb  # noqa: F401
