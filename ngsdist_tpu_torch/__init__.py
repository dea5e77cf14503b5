"""ngsdist_tpu_torch — the PyTorch and CUDA port of ngsdist_tpu.

Pairwise genetic distances from genotypes, genotype likelihoods or
posterior probabilities on one NVIDIA Hopper card (or the CPU), with
the same ngsDist command line and the same output bytes as the JAX
package `ngsdist_tpu`, which stays the reference:

  - cli.py / __main__.py: `python -m ngsdist_tpu_torch`
  - runner.py: stage banners, checkpoints, output
  - core/distance.py: the resident single-device engine
  - ops/indep.py, ops/em.py: plain PyTorch versions and the CUDA
    kernels of csrc/, built with nvcc at first use (ops/_build.py)

  - config.py, io/, core/{bootstrap,models,preprocess,exact}.py,
    utils/: the host layer (parameters, readers, preprocessing, the
    bootstrap stream, writers, checkpoints, signals), the port's own
    copy of the JAX package's modules of the same names, with the
    native C runtime of csrc/host/ built at first use (utils/native.py)

The package imports torch and numpy, never jax and nothing of
`ngsdist_tpu`.
"""
