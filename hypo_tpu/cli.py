"""Command-line interface mirroring the reference's flag surface
(reference src/main.cpp:46-430; same short options)."""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import (STAGE_BEG, InputFlags, ScoreParams, get_expected_file_sz,
                     get_kmer_len)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hypo_tpu",
        description="hybrid assembly polisher with GPU window "
                    "consensus (capabilities of kensung-lab/hypo)")
    ap.add_argument("-r", "--reads-short", required=True, action="append",
                    help="short reads (fasta/fastq[.gz]); @file-of-names "
                         "supported; repeatable")
    ap.add_argument("-d", "--draft", required=True)
    ap.add_argument("-b", "--bam-sr", required=True)
    ap.add_argument("-c", "--coverage-short", type=int, required=True)
    ap.add_argument("-s", "--size-ref", required=True,
                    help="approx genome size (e.g. 4.6m, 3g)")
    ap.add_argument("-B", "--bam-lr", default="")
    ap.add_argument("-o", "--output", default="")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-p", "--processing-size", type=int, default=0)
    ap.add_argument("-k", "--kind-sr", default="sr", choices=["sr", "ccs"])
    ap.add_argument("-m", "--match-sr", type=int, default=5)
    ap.add_argument("-x", "--mismatch-sr", type=int, default=-4)
    ap.add_argument("-g", "--gap-sr", type=int, default=-8)
    ap.add_argument("-M", "--match-lr", type=int, default=3)
    ap.add_argument("-X", "--mismatch-lr", type=int, default=-5)
    ap.add_argument("-G", "--gap-lr", type=int, default=-4)
    ap.add_argument("-q", "--qual-map-th", type=int, default=2)
    ap.add_argument("-n", "--ned-th", type=int, default=20)
    ap.add_argument("-i", "--intermed", action="store_true")
    ap.add_argument("--device-poa", action="store_true", default=None,
                    help="force window consensus onto the JAX device "
                         "path (default: auto — device iff JAX's "
                         "default backend is a GPU)")
    ap.add_argument("--no-device-poa", dest="device_poa",
                    action="store_false",
                    help="force the host consensus engine")
    ap.add_argument("--device-poa-mode", default="full",
                    choices=["full", "exact"],
                    help="full: whole POA on device (one dispatch per "
                         "window bucket); exact: per-round device DP, "
                         "bit-identical to the host engine")
    ap.add_argument("--aux-dir", default="aux")
    ap.add_argument("--nproc", type=int, default=1,
                    help="number of polishing processes; contigs are "
                         "split into contiguous draft-order ranges.  "
                         "Without --coordinator, process i takes card "
                         "i %% (visible cards)")
    ap.add_argument("--procid", type=int, default=0,
                    help="this process's rank in [0, nproc)")
    ap.add_argument("--coordinator", default="",
                    help="jax.distributed coordinator address "
                         "(host:port) for several hosts; optional")
    ap.add_argument("--inspect", action="store_true",
                    help="write aux/regions.bed and aux/inspect.txt "
                         "(reference generate_inspect_file artifacts)")
    return ap


def flags_from_args(args) -> InputFlags:
    if args.gap_sr >= 0 or args.gap_lr >= 0:
        raise SystemExit("gap penalties must be negative")
    sr_files: List[str] = []
    for r in args.reads_short:
        if r.startswith("@"):
            with open(r[1:]) as fh:
                sr_files.extend(x.strip() for x in fh if x.strip())
        else:
            sr_files.append(r)
    for p in sr_files + [args.draft, args.bam_sr] + (
            [args.bam_lr] if args.bam_lr else []):
        if not os.path.exists(p):
            raise SystemExit(f"file does not exist: {p}")
    output = args.output
    if not output:
        base = os.path.basename(args.draft)
        stem = base.rsplit(".", 1)[0]
        output = f"hypo_{stem}.fasta"
    done_stage = STAGE_BEG
    stagefile = os.path.join(args.aux_dir, "stage.txt")
    if args.intermed and os.path.exists(stagefile):
        with open(stagefile) as fh:
            for line in fh:
                parts = line.split()
                if parts:
                    try:
                        done_stage = int(parts[-1])
                    except ValueError:
                        pass
    flags = InputFlags(
        sr_filenames=sr_files,
        sr_bam_filename=args.bam_sr,
        lr_bam_filename=args.bam_lr,
        draft_filename=args.draft,
        output_filename=output,
        score_params=ScoreParams(args.match_sr, args.mismatch_sr,
                                 args.gap_sr, args.match_lr,
                                 args.mismatch_lr, args.gap_lr),
        map_qual_th=args.qual_map_th,
        norm_edit_th=args.ned_th,
        threads=args.threads,
        processing_batch_size=args.processing_size,
        k=max(2, get_kmer_len(args.size_ref)),
        cov=args.coverage_short,
        sz_in_gb=get_expected_file_sz(args.size_ref, args.coverage_short),
        done_stage=done_stage,
        intermed=args.intermed,
        kind=args.kind_sr,
        aux_dir=args.aux_dir,
        use_device_poa=args.device_poa,
        device_poa_mode=args.device_poa_mode,
        inspect=args.inspect,
        num_processes=args.nproc,
        process_id=args.procid,
        coordinator=args.coordinator,
    )
    if not (0 <= flags.process_id < flags.num_processes):
        raise SystemExit("--procid must be in [0, --nproc)")
    return flags


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    flags = flags_from_args(args)
    print(f"[hypo_tpu] k={flags.k} output={flags.output_filename}",
          file=sys.stderr)
    from .pipeline.polish import polish
    polish(flags)


if __name__ == "__main__":
    main()
