"""End-to-end orchestration for the PyTorch port: config -> read ->
preprocess -> distances -> output.

Port of ngsdist_tpu/runner.py, running the port's engine
(core/distance.py) on one device or over a mesh of them
(parallel/mesh.py): resident where the tensor fits the device budget,
streamed in site chunks (or rounds of shards) where it does not.  The host
layer (readers, preprocessing, bootstrap maps, writers, checkpoints,
signals) is the port's own copy of the JAX package's, module by module
under the same names.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, TextIO

import numpy as np
import torch

from .config import NgsDistError, Params
from .core import distance
from .core import exact as exact_engine
from .core import models
from .core.preprocess import preprocess
from .core.submodels import encode_alleles
from .io import readers, writers
from .utils import checkpoint as ckpt
from .utils import native, profiling, signals
from .utils.hostmem import (CodedProbs, coded_call_lut, coded_upload_enabled, derive_codes,
                             upload16_enabled, upload23_enabled)
from .utils.profiling import Throughput


def host_runtime():
    """The native host runtime (readers, exp, phylip writer), built with
    the host C compiler at first use; returns the loaded library."""
    return native.get_lib()


def _log(pars: Params, level: int, msg: str) -> None:
    if pars.verbose >= level:
        print(msg, file=sys.stderr)


def _fused_packed_wanted(pars: Params, device: torch.device, mesh=None,
                         x64: bool = False) -> bool:
    """True when the genotype read should be DEFERRED to the engine as a
    fused-read handle (readers.PackedBinInput): the engine then pulls
    upload-ready packed float32 chunks straight from disk — one native
    pass instead of read + exp + cast over a resident float64 tensor,
    with chunk reads overlapping the uploads.  Requires a raw seekable
    binary file, the float32 dtype with its two-component lane on (not
    --x64, not NGSDIST_UPLOAD23=0: utils/hostmem.py upload23_enabled), an
    engine stage that never needs the host tensor (no genotype calling,
    no per-site debug replay), and one device: a mesh run shards the host
    tensor, as the JAX runner's does.  The handle's lane, uint16 or
    float32 pairs, is the device's (load_inputs).  NGSDIST_FUSED_READ=0
    forces the staged pipeline."""
    if mesh is not None:
        return False
    if os.environ.get("NGSDIST_FUSED_READ", "auto") == "0":
        return False
    if not pars.in_bin or not readers.is_raw_seekable_binary(pars.in_geno):
        return False  # the fused reader needs a raw regular file (magic sniff)
    if pars.call_geno or pars.evol_model >= 3 or pars.verbose >= 8:
        return False
    if not native.have_native():
        return False
    dtype = distance.default_dtype(device, x64)
    return dtype == torch.float32 and upload23_enabled(dtype)


def _fused_coded_wanted(pars: Params, device: torch.device, mesh=None, x64: bool = False):
    """Route of the fused native codes reader (readers.read_geno_codes;
    ngsdist_tpu/runner.py:65-118): default-threshold --call_geno calls
    every triple of a raw binary file to a one-hot or the uniform missing
    value, so one native pass gives its uint8 code plane, one byte a
    triple, and the staged read -> call_geno -> exp -> derive_codes chain
    never runs.  Returns

    - "handle": reads deferred to a readers.CodedBinInput, the engine
      pulling code chunks from disk as it uploads them; no plane is
      resident.  One device; it also takes the place of a lazy stream at
      any size;
    - "eager": the code plane read whole first (a CodedProbs): a mesh,
      whose shards slice it, when it fits the host budget; and a chunked
      bootstrap, which then slices every replicate's chunks from memory
      and does not read the file again;
    - False: not this reader (the gate SiteStream.coded_call_eligible, a
      raw seekable binary file); a mesh over the host budget then reads
      coded rounds lazily, and a lazy run without a mesh over several
      cards takes them on a mesh of them."""
    from .parallel.multihost import SiteStream

    if not pars.in_bin or not readers.is_raw_seekable_binary(pars.in_geno):
        return False  # the fused reader needs a raw regular file (magic sniff)
    if not SiteStream.coded_call_eligible(pars, distance.default_dtype(device, x64)):
        return False
    S, N = pars.n_sites, pars.n_ind
    plane_fits = S * N * 2 <= SiteStream._host_budget_bytes()  # plane and a shard's copy
    if mesh is not None:
        return "eager" if plane_fits else False
    if (_lazy_stream_wanted(pars, device, x64) and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        return False  # a lazy run shards over every visible card
    chunked, _ = distance.stream_plan(S, N, device,
                                      distance.check_fits(S, N, device, pars.indep_geno, x64),
                                      x64)
    if chunked and pars.n_boot_rep and plane_fits:
        return "eager"
    return "handle"


def _lazy_stream_wanted(pars: Params, device: torch.device, x64: bool = False) -> bool:
    """True when reading the genotype tensor eagerly would exceed the host
    budget (ngsdist_tpu/runner.py:172): the run then reads its rounds from
    disk through a lazy SiteStream, so host memory no longer bounds the
    genome's length.  The predicate and its byte estimate are
    SiteStream.wants_lazy's, which from_reader takes too."""
    from .parallel.multihost import SiteStream

    return SiteStream.wants_lazy(pars, distance.default_dtype(device, x64), pars.n_sites)


def load_inputs(pars: Params, fused: bool = False, geno: bool = True, coded=False,
                device: Optional[torch.device] = None):
    """Read labels, positions and the genotype tensor; returns
    (labels, pos_rows, P_normal [n_sites, n_ind, 3]).  fused=True
    returns a readers.PackedBinInput handle instead of the tensor (the
    engine reads fused packed chunks on demand) in the lane of `device`
    (uint16 pairs where utils/hostmem.py upload16_enabled); coded (_fused_coded_wanted)
    "handle" a readers.CodedBinInput, "eager" the code plane as a
    utils/hostmem.CodedProbs; geno=False reads no genotypes (P is None: a
    lazy run reads them round by round)."""
    if pars.in_labels:
        _log(pars, 1, "==> Reading labels")
        labels = readers.read_labels(pars.in_labels, pars.in_labels_header, pars.n_ind)
    else:
        labels = readers.default_labels(pars.n_ind)
    if pars.verbose >= 4:
        for lbl in labels:
            print(lbl, file=sys.stderr)

    pos_rows = None
    if pars.in_pos:
        _log(pars, 1, "==> Reading positions file")
        pos_rows = readers.read_pos(pars.in_pos, pars.in_pos_header, pars.n_sites)
        if pars.verbose >= 4:
            for row in pos_rows:
                print("\t".join((row + ["", "", "", ""])[:4]), file=sys.stderr)

    _log(pars, 1, "==> Reading genotype data")
    if not geno:
        return labels, pos_rows, None
    if fused:
        u16 = device is not None and upload16_enabled(torch.float32, device)
        return labels, pos_rows, readers.PackedBinInput(pars, u16=u16)
    if coded == "handle":
        return labels, pos_rows, readers.CodedBinInput(pars)
    if coded:
        with profiling.host_span("read"):
            got = readers.read_geno_codes(pars.in_geno, pars.in_logscale, pars.n_ind,
                                          pars.n_sites)
        if got is None:  # not raw binary after all (TOCTOU): hard error
            raise NgsDistError("read_geno", "cannot read binary GENO file. Check GENO file "
                               "and number of sites!")
        codes, any_missing = got
        return labels, pos_rows, CodedProbs(None, codes, coded_call_lut(any_missing))
    with profiling.host_span("read"):
        geno_log = readers.read_geno(
            pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale,
            pars.n_ind, pars.n_sites,
        )
        P = preprocess(geno_log, pars.call_geno, pars.N_thresh, pars.call_thresh)
    return labels, pos_rows, P


def make_pair_report(pars: Params, labels):
    """verbose>=3 per-pair stats line (ngsDist.cpp:366-367): raw distance
    sum, valid-site count and their ratio, before model correction."""
    if pars.verbose < 3:
        return None

    def on_stats(raw, denom):
        d = np.asarray(denom)
        for i1 in range(pars.n_ind):
            for i2 in range(i1 + 1, pars.n_ind):
                cnt = d[i1, i2] if d.ndim == 2 else float(denom)
                avg = raw[i1, i2] / cnt if cnt else float("nan")
                print(
                    f"\tDistance of {raw[i1, i2]:f} from {int(cnt)} valid sites "
                    f"({avg:f}) between {labels[i1]} (ind {i1}) and "
                    f"{labels[i2]} (ind {i2})!",
                    file=sys.stderr,
                )

    return on_stats



def iter_replicates(pars: Params, P, device: torch.device,
                    on_stats=None, labels=None, start_rep: int = 0,
                    round_ckpt: bool = False, alleles=None, mesh=None, x64: bool = False):
    """Yield the distance matrices for replicates start_rep..n_boot_rep,
    printing each replicate's stage banners before its matrix is pulled
    (reference ngsDist.cpp:223-242).  P: the host tensor or a fused-read
    handle; round_ckpt: see distance.iter_replicates; alleles: the
    sites' (a1, a2) allele codes, which models 3-6 need; mesh: a
    parallel.mesh.Mesh to shard the run over (device is its first); x64:
    float64 on a card."""
    # The reference accepts models 3-6 and aborts inside its first pair
    # task; this engine computes them (core/submodels.py) from the POS
    # file's alleles.
    if pars.evol_model < 3:
        models.check_model_supported(pars.evol_model)
    elif alleles is None:
        raise NgsDistError(
            "main", "evolutionary models need allele info in the POS file!")

    _log(pars, 2, "==> Setting seed for random number generator")
    n_trunc, maps = distance.bootstrap_site_maps(
        pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size)

    # verbose>=8 per-site firehose: replayed by the exact engine's
    # host-side replayer, as the JAX engine does; the matrices in the
    # output still come from this engine.  A lazy run has no tensor to
    # replay.
    dump_P_ind = None
    if pars.verbose >= 8:
        if isinstance(P, np.ndarray):
            dump_P_ind = exact_engine.to_ind_major(P)
        else:
            print("WARN: [main] verbose>=8 per-site dump unavailable "
                  "on disk-streamed (lazy) runs; rerun with a larger "
                  "NGSDIST_HOST_BUDGET or python -m ngsdist_tpu --engine exact.",
                  file=sys.stderr)
    dump_labels = labels if labels is not None else readers.default_labels(pars.n_ind)

    gen = distance.iter_replicates(pars, P, maps, n_trunc, device,
                                   on_stats=on_stats, start_rep=start_rep,
                                   round_ckpt=round_ckpt, alleles=alleles, mesh=mesh, x64=x64)
    for rep in range(start_rep, pars.n_boot_rep + 1):
        _log(pars, 1, "==> Analyzing full dataset..." if rep == 0
             else f"==> Bootstrap replicate # {rep} ...")
        _log(pars, 2, "> Mapping positions...")
        if pars.verbose >= 5 and rep > 0:
            # bootstrap block-mapping dump (rnd_map_data, ngsDist.cpp:430-431)
            bs = pars.boot_block_size
            site_map = maps[rep - 1]
            for block in range(len(site_map) // bs):
                for s_off in range(bs):
                    dest = block * bs + s_off
                    src = int(site_map[dest])
                    print(f"block: {block}	orig_site: {dest}	"
                          f"rand_block:{src // bs}	rand_site: {src}",
                          file=sys.stderr)
        _log(pars, 2, "> Calculating pairwise genetic distances...")
        if dump_P_ind is not None:
            exact_engine.debug_site_dump(
                dump_P_ind, pars.score, pars.indep_geno, pars.pairwise_del,
                dump_labels, pars.verbose,
                site_map=None if rep == 0 else maps[rep - 1],
                n_used=pars.n_sites if rep == 0 else n_trunc,
            )
        try:
            yield next(gen)
        except StopIteration:
            return


def run(pars: Params, device: Optional[torch.device] = None, out_fh: Optional[TextIO] = None,
        resume: bool = False, report_throughput: bool = False, mesh=None,
        x64: bool = False, trace_dir: Optional[str] = None) -> List[np.ndarray]:
    """Full pipeline; writes matrices to pars.out (or out_fh) and returns
    them.  resume: continue an interrupted run from its .ckpt.json
    sidecar.  report_throughput: print pair-site updates/s to stderr.
    mesh: a parallel.mesh.Mesh to shard the sites (and pairs) over; the
    run's device is then its first, and its checkpoint engine that
    device's, so a run resumes across mesh shapes as the JAX runner's
    does.  device None: the card (an NgsDistError without one; the CPU
    only when asked for).  An input whose eager read would exceed the
    host budget (_lazy_stream_wanted) is read from disk in rounds over
    the mesh, or, without one, over every visible card (the CPU: one
    `cpu` entry).  x64: compute in float64 on a card (--x64, the JAX
    package's md5 mode): the staged read in float64, no fused pack23 read
    and no code plane, the kernels' float64 entries; the CPU path is
    float64 either way.  trace_dir: write a torch.profiler trace of the
    compute section there (utils/profiling.py trace; --trace_dir)."""
    if mesh is not None:
        device = mesh.first
    elif device is None:
        if not torch.cuda.is_available():
            raise NgsDistError("main", "no CUDA device is available (runner.run runs on the "
                               "card unless it is given device=torch.device('cpu'))")
        device = torch.device("cuda", torch.cuda.current_device())
    pars.validate()
    try:
        pars.finalize()
    finally:
        # stage banners accumulated before a finalize-time fatal still
        # reach stderr in order, as the reference prints them as it goes
        for msg in pars.messages:
            print(msg, file=sys.stderr)

    coded = _fused_coded_wanted(pars, device, mesh, x64)
    lazy = not coded and _lazy_stream_wanted(pars, device, x64)
    fused = not lazy and not coded and _fused_packed_wanted(pars, device, mesh, x64)
    if not lazy:
        labels, pos_rows, P = load_inputs(pars, fused=fused, coded=coded, device=device)
    else:
        labels, pos_rows, _ = load_inputs(pars, geno=False)
        from .parallel import make_mesh
        from .parallel.multihost import SiteStream

        if mesh is None:
            mesh = make_mesh(None if device.type == "cuda" else [device])
        P = SiteStream.from_reader(pars, mesh, x64)
    if (isinstance(P, np.ndarray) and pars.evol_model <= 2 and pars.verbose < 8
            and (not pars.in_probs or pars.call_geno)
            and coded_upload_enabled(distance.default_dtype(device, x64))):
        # Hard genotypes and --call_geno give one-hot and uniform triples:
        # upload the code plane, one byte a triple, where the scan finds
        # one (ngsdist_tpu/runner.py:415-440); it gives up at the first
        # chunk of other triples (a thresholded call leaves soft ones)
        with profiling.host_span("scan"):
            got = derive_codes(P)
        if got is not None:
            P = CodedProbs(P, *got)
    alleles = None
    if pars.evol_model >= 3 and pos_rows is not None:
        alleles = encode_alleles(pos_rows)
    ckpt_engine = distance.engine_name(device, x64)

    n_done = 0
    if resume and out_fh is None:
        got = ckpt.load(pars.out, pars, engine=ckpt_engine)
        if got is not None:
            n_done = got
            _log(pars, 1, f"==> Resuming: {n_done} matrices already written")

    close = False
    if out_fh is None:
        try:
            out_fh = open(pars.out, "a" if n_done else "w")
        except OSError as ex:
            raise NgsDistError("main", "cannot open output file!",
                               err=ex.errno or 0)
        close = True
    matrices: List[np.ndarray] = []
    meter = Throughput(pars.n_comb)
    # true per-replicate update counts arrive through the stats hook
    pending_updates: List[float] = []
    # at verbose>=8 the exact replayer prints the pair-stats lines itself
    user_stats = None if pars.verbose >= 8 else make_pair_report(pars, labels)

    def on_stats(raw, cnt):
        if isinstance(cnt, np.ndarray):
            iu = np.triu_indices(pars.n_ind, 1)
            pending_updates.append(float(np.sum(cnt[iu])))
        else:
            pending_updates.append(float(pars.n_comb) * float(cnt))
        if user_stats is not None:
            user_stats(raw, cnt)

    bs = pars.boot_block_size
    n_trunc = pars.n_sites - pars.n_sites % bs if pars.n_boot_rep else pars.n_sites
    interrupted = False
    try:
        with profiling.trace(trace_dir):
            for rep, m in enumerate(
                iter_replicates(pars, P, device, on_stats=on_stats, labels=labels,
                                start_rep=n_done, alleles=alleles, mesh=mesh, x64=x64,
                                # round-level durability of the sums of
                                # streamed long-genome replicates
                                round_ckpt=close),
                start=n_done,
            ):
                n_used = pars.n_sites if rep == 0 else n_trunc
                got = pending_updates.pop() if pending_updates else (
                    float(pars.n_comb) * float(n_used))
                _log(pars, 2, "> Printing distance matrix")
                with profiling.replicate(rep), profiling.host_span("write"):
                    writers.write_dist_matrix(out_fh, labels, m)
                    out_fh.flush()
                    if close:
                        ckpt.save(pars.out, pars, rep + 1, engine=ckpt_engine)
                matrices.append(m)
                meter.add_updates(got)
                if signals.stop_requested():
                    _log(pars, 1, "==> Stop requested; output is resumable (--resume)")
                    interrupted = True
                    break
    finally:
        if close:
            out_fh.close()
        if lazy:
            P.close()  # delete an owned spill cache
    if close and not interrupted:
        ckpt.clear(pars.out)
    if report_throughput:
        meter.report()
    _log(pars, 1, "==> Freeing memory...")  # teardown banner (ngsDist.cpp:303)
    _log(pars, 1, "Done!")
    return matrices
