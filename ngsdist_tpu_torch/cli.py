"""ngsDist-compatible command line for the PyTorch port.

Accepts the exact flag surface of the reference
(reference parse_args.cpp:52-164) with getopt_long_only semantics:
single- or double-dash long options, unambiguous prefix matching, and
single-letter short-option fallback when a prefix is ambiguous.  Errors
and the verbose>=1 argument echo follow the reference's wording; fatal
errors exit with status 255 (C exit(-1)).  The parser and the echo are
the port's own copy of the JAX package's.  Port-specific options:

  --platform cuda|cpu   device to run on (default cuda; cuda without a
                        card is an error, never a silent CPU run)
  --engine torch        the port's one engine (also what the shared
                        parser's `auto`, its value when the flag is
                        absent, means); the JAX package's engines run
                        under python -m ngsdist_tpu
  --devices N|all       shard the sites over N devices (all: every
                        visible card); on the CPU, N `cpu` shards, as the
                        JAX package's virtual CPU mesh; asking for more
                        cards than are visible is an error
  --pairs K             a second mesh axis: split the pairs K ways (the
                        device count must be a multiple of K)
  --coordinator HOST:PORT --num_processes P --process_id I
                        one of P processes of a run (gloo over TCP; process
                        0 listens at HOST:PORT and writes the output); each
                        drives the devices it sees (--platform), reads its
                        own site range and writes, with the others, the
                        bytes of one process over all their devices when
                        both cut the same rounds (the same device budget;
                        not where the host budget cuts either's rounds)

Usage:  python -m ngsdist_tpu_torch [options] --geno FILE --n_ind N --n_sites N --out FILE
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

import torch

from .config import EVOL_MODEL_NAMES, NgsDistError, Params
from .utils import signals
from .version import __version__

# (long name, takes_arg, short char) — parse_args.cpp:54-83.
_OPTIONS = [
    ("geno", True, "g"),
    ("probs", False, "p"),
    ("log_scale", False, "l"),
    ("n_ind", True, "n"),
    ("n_sites", True, "s"),
    ("tot_sites", True, "S"),
    ("labels", True, "L"),
    ("labelsH", True, "H"),
    ("pos", True, "a"),
    ("posH", True, "A"),
    ("call_geno", False, "c"),
    ("N_thresh", True, "N"),
    ("call_thresh", True, "C"),
    ("pairwise_del", False, "D"),
    ("avg_nuc_dist", False, "d"),
    ("evol_model", True, "m"),
    ("indep_geno", False, "I"),
    ("n_boot_rep", True, "b"),
    ("boot_block_size", True, "B"),
    ("out", True, "o"),
    ("n_threads", True, "x"),
    ("verbose", True, "V"),
    ("seed", True, "r"),
]
_BY_NAME = {name: (name, arg, short) for name, arg, short in _OPTIONS}
_BY_SHORT = {short: (name, arg, short) for name, arg, short in _OPTIONS}

# Extra long options of this framework (not in the reference): the same
# list as python -m ngsdist_tpu parses, so that a command line resolves
# identically under both; main() refuses the ones in _NOT_PORTED.
_EXT_OPTIONS = [
    ("engine", True),       # torch | auto
    ("devices", True),      # shard sites over N devices
    ("pairs", True),        # 2nd mesh axis: split the pair dimension K ways
    ("resume", False),      # continue an interrupted run (.ckpt.json sidecar)
    ("trace_dir", True),    # capture a device trace here
    ("throughput", False),  # report pair-site updates/sec on stderr
    ("coordinator", True),  # multi-host: coordinator host:port
    ("num_processes", True),
    ("process_id", True),
    ("platform", True),     # cuda | cpu
    ("x64", False),         # float64 on the device
]
_EXT_BY_NAME = dict(_EXT_OPTIONS)


def _atol(s: str) -> int:
    """C atol/atoi: parse a leading integer, 0 if none."""
    s = s.strip()
    sign = 1
    i = 0
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    return sign * int(s[i:j]) if j > i else 0


_C_ATOF_RE = re.compile(
    r"""\s*[+-]?(
        0[xX]([0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)([pP][+-]?\d+)? |
        (\d+\.?\d*|\.\d+)([eE][+-]?\d+)? |
        [iI][nN][fF]([iI][nN][iI][tT][yY])? |
        [nN][aA][nN](\([0-9a-zA-Z_]*\))?
    )""",
    re.X,
)


def _atof(s: str) -> float:
    """C atof: longest valid strtod prefix, 0 if none — including the
    forms plain float() or a decimal-only regex miss: hex floats
    (0x1.8p3), inf/infinity and nan/nan(chars), case-insensitive
    (parse_args.cpp uses atof for N_thresh/call_thresh, so
    `--N_thresh inf` must parse +inf here too)."""
    m = _C_ATOF_RE.match(s)
    if not m:
        return 0.0
    tok = m.group(0).strip()
    body = tok.lstrip("+-")
    neg = tok[: len(tok) - len(body)].count("-") % 2 == 1
    low = body.lower()
    if low.startswith("0x"):
        v = float.fromhex(body)
    elif low.startswith("nan"):
        v = float("nan")
    else:
        v = float(body)
    return -v if neg else v


def _resolve(name: str, long_only: bool = False):
    """getopt_long_only resolution: exact match, then unambiguous prefix,
    then (single-dash tokens only) single-char short-option fallback.

    REFERENCE options strictly outrank the framework's extra options at
    every stage — a script written for ngsDist must resolve identically
    here (e.g. `--pair` is pairwise_del, `-x 4` is n_threads, `--e 2`
    is evol_model), no matter what extensions exist.  A `--`-prefixed
    token never falls back to a short option (glibc getopt_long_only),
    so `--n` is ambiguous even though `-n` is the n_ind short."""
    if name in _BY_NAME:
        return _BY_NAME[name], False
    if name in _EXT_BY_NAME:
        return (name, _EXT_BY_NAME[name], None), True
    matches = [o for o in _OPTIONS if o[0].startswith(name)]
    if len(matches) == 1:
        return matches[0], False
    if not long_only and len(name) == 1 and name in _BY_SHORT:
        return _BY_SHORT[name], False
    if len(matches) > 1:
        # getopt_long_only: an ambiguous prefix is its own fatal, with
        # the candidate list, and NO error() block (parse_args.cpp's
        # default: exit(-1) after getopt already printed)
        return ("?ambiguous", matches), False
    ext_matches = [o for o in _EXT_OPTIONS if o[0].startswith(name)]
    if len(ext_matches) == 1:
        return (ext_matches[0][0], ext_matches[0][1], None), True
    return None, False


def parse_args(argv: List[str]):
    """Parse into (Params, extras dict); raises SystemExit(255) on bad flags."""
    pars = Params()
    extras = {"engine": "auto", "devices": None}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--":
            break  # getopt end-of-options marker; the rest are ignored
        if not tok.startswith("-") or tok == "-":
            # getopt permutes non-option arguments to the end and the
            # reference never examines them — silently ignored
            i += 1
            continue
        name = tok.lstrip("-")
        val: Optional[str] = None
        if "=" in name:
            name, val = name.split("=", 1)
        opt, is_ext = _resolve(name, long_only=tok.startswith("--"))
        if opt is None:
            print(f"ngsdist_tpu: unrecognized option '{tok}'", file=sys.stderr)
            raise SystemExit(255)
        if opt[0] == "?ambiguous":
            cands = " ".join(f"'--{o[0]}'" for o in opt[1])
            print(f"ngsdist_tpu: option '{tok}' is ambiguous; "
                  f"possibilities: {cands}", file=sys.stderr)
            raise SystemExit(255)
        lname, takes_arg = opt[0], opt[1]
        if takes_arg and val is None:
            i += 1
            if i >= len(argv):
                print(f"ngsdist_tpu: option '{tok}' requires an argument", file=sys.stderr)
                raise SystemExit(255)
            val = argv[i]
        i += 1

        if is_ext:
            extras[lname] = val if takes_arg else True
            continue
        if lname == "geno":
            pars.in_geno = val
        elif lname == "probs":
            pars.in_probs = True
        elif lname == "log_scale":
            pars.in_logscale = True
            pars.in_probs = True
        elif lname == "n_ind":
            pars.n_ind = _atol(val)
        elif lname == "n_sites":
            pars.n_sites = _atol(val)
        elif lname == "tot_sites":
            pars.tot_sites = _atol(val)
        elif lname == "labels":
            pars.in_labels = val
            pars.in_labels_header = False
        elif lname == "labelsH":
            pars.in_labels = val
            pars.in_labels_header = True
        elif lname == "pos":
            pars.in_pos = val
            pars.in_pos_header = False
        elif lname == "posH":
            pars.in_pos = val
            pars.in_pos_header = True
        elif lname == "call_geno":
            pars.call_geno = True
        elif lname == "N_thresh":
            pars.N_thresh = _atof(val)
            pars.call_geno = True
        elif lname == "call_thresh":
            pars.call_thresh = _atof(val)
            pars.call_geno = True
        elif lname == "pairwise_del":
            pars.pairwise_del = True
        elif lname == "avg_nuc_dist":
            pars.avg_nuc_dist = True
        elif lname == "evol_model":
            pars.evol_model = _atol(val)
        elif lname == "indep_geno":
            pars.indep_geno = True
        elif lname == "n_boot_rep":
            pars.n_boot_rep = _atol(val)
        elif lname == "boot_block_size":
            pars.boot_block_size = _atol(val)
        elif lname == "out":
            pars.out = val
        elif lname == "n_threads":
            pars.n_threads = _atol(val)
        elif lname == "verbose":
            pars.verbose = _atol(val)
        elif lname == "seed":
            pars.seed = _atol(val)
    return pars, extras


def echo_args(pars: Params) -> None:
    """Argument echo at verbose>=1 (parse_args.cpp:167-194)."""
    if pars.verbose < 1:
        return
    # an out-of-range model indexes past the reference's name array and
    # glibc printf renders the NULL it happens to read as "(null)"
    # (parse_args.cpp:168 with evol_model[] at parse_args.cpp:41-48)
    model_name = (EVOL_MODEL_NAMES[pars.evol_model]
                  if 0 <= pars.evol_model <= 6 else "(null)")
    b = lambda x: "true" if x else "false"  # noqa: E731
    # C printf %s with a NULL pointer prints "(null)" (parse_args.cpp:168)
    s = lambda x: "(null)" if x is None else x  # noqa: E731
    h = lambda x: "WITH" if x else "WITHOUT"  # noqa: E731
    sys.stderr.write(
        "==> Input Arguments:\n"
        f"\tgeno: {s(pars.in_geno)}\n\tprobs: {b(pars.in_probs)}\n\tlog_scale: {b(pars.in_logscale)}\n"
        f"\tn_ind: {pars.n_ind}\n\tn_sites: {pars.n_sites}\n\ttot_sites: {pars.tot_sites}\n"
        f"\tlabels: {s(pars.in_labels)} ({h(pars.in_labels_header)} header)\n"
        f"\tpositions: {s(pars.in_pos)} ({h(pars.in_pos_header)} header)\n"
        f"\tcall_geno: {b(pars.call_geno)}\n\tN_thresh: {pars.N_thresh:f}\n"
        f"\tcall_thresh: {pars.call_thresh:f}\n\tpairwise_del: {b(pars.pairwise_del)}\n"
        f"\tavg_nuc_dist: {b(pars.avg_nuc_dist)}\n\tevol_model: {model_name}\n"
        f"\tgeno_indep: {b(pars.indep_geno)}\n\tn_boot_rep: {pars.n_boot_rep}\n"
        f"\tboot_block_size: {pars.boot_block_size}\n\tout: {pars.out}\n"
        f"\tn_threads: {pars.n_threads}\n\tverbose: {pars.verbose}\n\tseed: {pars.seed}\n"
        f"\tversion: {__version__}\n\n"
    )
    if pars.verbose > 4:
        sys.stderr.write(
            "==> Verbose values greater than 4 for debugging purpose only. "
            "Expect large amounts of info on screen\n"
        )


# JAX-package options that have no counterpart in the port yet.
_NOT_PORTED = ("trace_dir", "x64")

# Options a multi-process run cannot honour (ngsdist_tpu/cli.py:299-313).
_NOT_WITH_COORDINATOR = ("trace_dir", "throughput", "devices", "pairs")


def _device(platform: str) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise NgsDistError("main", f"unknown --platform {platform!r} "
                           "(ngsdist_tpu_torch runs on cuda or cpu)")
    if not torch.cuda.is_available():
        raise NgsDistError("main", "--platform cuda: no CUDA device is "
                           "available (--platform cpu runs the float64 "
                           "CPU path)")
    return torch.device("cuda", torch.cuda.current_device())


def _mesh(device: torch.device, devices, pairs_arg):
    """The mesh of --devices N|all and --pairs K, or None for one
    device (ngsdist_tpu/cli.py:328-335): N `cpu` entries on the CPU; on
    the cards, the first N visible ones."""
    pairs = _atol(pairs_arg or "1") or 1
    if devices in (None, "", "0", "1") and pairs <= 1:
        return None
    from .parallel import make_mesh

    if device.type == "cpu":
        n = 1 if devices in (None, "", "all") else _atol(devices)
        avail = [device] * n
    else:
        avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(avail) if devices in (None, "", "all") else _atol(devices)
        if n > len(avail):
            raise NgsDistError("main", f"--devices {n}: only {len(avail)} CUDA devices are "
                               "visible (a mesh never runs on fewer cards than asked)")
    try:
        return make_mesh(avail, n_devices=n, pairs=pairs)
    except ValueError as ex:
        raise NgsDistError("main", str(ex))


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pars, extras = parse_args(argv)
    echo_args(pars)
    try:
        if extras.get("coordinator"):
            for bad in _NOT_WITH_COORDINATOR:
                if extras.get(bad):
                    raise NgsDistError("main", f"--{bad} is not supported with --coordinator")
        for opt in _NOT_PORTED:
            if extras.get(opt) not in (None, False):
                raise NgsDistError(
                    "main", f"--{opt} is not yet supported by "
                    "ngsdist_tpu_torch (see ROADMAP.md)")
        engine = extras.get("engine") or "auto"
        if engine not in ("torch", "auto"):
            raise NgsDistError(
                "main", f"unknown engine {engine!r}: ngsdist_tpu_torch runs "
                "its torch engine only (the JAX package's engines run under "
                "python -m ngsdist_tpu)")
        device = _device(extras.get("platform") or "cuda")
        if extras.get("coordinator"):
            from .parallel.multihost import run_distributed

            run_distributed(
                pars, coordinator=extras["coordinator"],
                num_processes=_atol(extras.get("num_processes") or "0") or None,
                process_id=(_atol(extras["process_id"])
                            if extras.get("process_id") is not None else None),
                resume=bool(extras.get("resume")), device=device)
            return 0
        for opt in ("num_processes", "process_id"):
            if extras.get(opt) is not None:
                raise NgsDistError("main", f"--{opt} needs --coordinator")
        mesh = _mesh(device, extras.get("devices"), extras.get("pairs"))

        from . import runner

        signals.arm()  # graceful 3-strikes stop (resumable output)
        runner.run(
            pars,
            device,
            resume=bool(extras.get("resume")),
            report_throughput=bool(extras.get("throughput")),
            mesh=mesh,
        )
    except NgsDistError as e:
        sys.stdout.flush()
        # error() block + perror("\t") suffix (gen_func.cpp:12-18)
        sys.stderr.write(f"\n=====\nERROR: [{e.func}] {e.msg}\n=====\n\n")
        sys.stderr.write(f"\t: {os.strerror(e.err) if e.err else 'Success'}\n")
        sys.stderr.flush()
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
