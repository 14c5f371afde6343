"""Command line of the PyTorch port.

  python -m seeksv_tpu_torch run [-o prefix] [--device cuda] [--normal n.bam]
                                 [--device-seed] [--device-align]
                                 [--device-align-auto] [--rescue]
                                 [--profile DIR] [--no-auto-calibrate]
                                 [--stream [--chunk-records N]]
                                 <ref.fa> <in.bam>
  python -m seeksv_tpu_torch aln      [-k N] [-2 mate2.fq] [--device cuda]
                                      <ref.fa> <reads.fq.gz> <out.sam>
  python -m seeksv_tpu_torch getclip  [-t -q -s -o] <input.sorted.bam>
  python -m seeksv_tpu_torch getsv    [-F -B -t -l -q -Q -w -n -b -d -D -e -m
                                       -i -f -T -L -r -a -R --rescue]
                                      <clip.bam|sam> <original.bam> <clip.gz>
                                      <out.sv> <out.unmapped.fq>
  python -m seeksv_tpu_torch somatic  [-t -q -l -m -n] <normal.bam>
                                      <normal.clip.gz> <tumor.sv> <out.sv>
  python -m seeksv_tpu_torch somatic-filter <somatic.temp.sv> <out.somatic.sv>
  python -m seeksv_tpu_torch vcf      <breakpoint.sv> [template.vcf] <out.vcf>
  python -m seeksv_tpu_torch index    <in.bam>
  python -m seeksv_tpu_torch view     <in.bam> <chrom:beg-end>
  python -m seeksv_tpu_torch cluster  [-n -q] <in.bam>
  python -m seeksv_tpu_torch simulate [-G -c --dels --invs --seed -o]
  python -m seeksv_tpu_torch compare  {simu,crest,seeksv} [-l -n -t -c --cnv]
                                      <control> <target> <out>

Every subcommand takes the flags of ``seeksv_tpu/cli.py`` and writes the
same bytes; ``run`` and ``aln`` add ``--device`` (``cuda``, or ``cpu``
for the kernels' plain versions).  ``aln -2`` runs both ends through the
device aligner; single-end ``aln`` is the host aligner, as in the
reference.  ``run`` on a CUDA device checks the dispatch calibration's
fingerprint first (``--no-auto-calibrate`` skips the check) and with
``--profile DIR`` writes a ``torch.profiler`` trace there, with the
program's ``seeksv.*`` spans and counters (``utils/trace.py``), for the
whole-BAM and the ``--stream`` driver alike.
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_getclip(sub):
    p = sub.add_parser("getclip", help="get soft-clipped reads")
    p.add_argument("-t", type=float, default=0.85, dest="threshold",
                   help="match-rate threshold for combining clips [0.85]")
    p.add_argument("-q", type=int, default=20, dest="min_mapq",
                   help="min mapping quality of soft-clipped reads [20]")
    p.add_argument("-s", action="store_true", dest="save_low_quality",
                   help="keep low-quality (XC-tagged) clips")
    p.add_argument("-o", default="output", dest="prefix")
    p.add_argument("bam")


def _add_getsv(sub):
    p = sub.add_parser("getsv", help="call SV junctions")
    p.add_argument("-F", dest="connect_bam", default=None)
    p.add_argument("-B", dest="temp_breakpoint", default=None)
    p.add_argument("-t", type=float, default=0.9, dest="threshold")
    p.add_argument("-l", type=int, default=50, dest="flank",
                   help="microhomology search length [50], 0-90")
    p.add_argument("-q", type=int, default=20, dest="min_mapq")
    p.add_argument("-Q", type=int, default=1, dest="min_mapq1",
                   help="(accepted for compatibility; unused in the "
                        "reference's v1.2.3 code path)")
    p.add_argument("-w", type=int, default=1, dest="min_mapq2")
    p.add_argument("-n", type=int, default=5_000_000, dest="read_pair_used")
    p.add_argument("-b", type=int, default=3, dest="sum_min_both_clip")
    p.add_argument("-d", type=int, default=50, dest="min_distance")
    p.add_argument("-D", action="store_true", dest="no_depth")
    p.add_argument("-e", type=int, default=0, dest="min_abnormal")
    p.add_argument("-f", type=float, default=0.1, dest="frequency")
    p.add_argument("-T", type=int, default=50, dest="max_microhomology")
    p.add_argument("-m", type=int, default=30, dest="min_seq_len")
    p.add_argument("-i", type=int, default=1, dest="max_seq_indel_no")
    p.add_argument("-L", type=int, default=200, dest="flank_length")
    p.add_argument("-r", action="store_true", dest="no_rescue_mode",
                   help="turn off rescue mode: reject SVs with clip "
                        "support on only one side (v1.2.0 flag)")
    p.add_argument("-a", type=int, default=5, dest="min_one_side_clip",
                   help="rescue mode: min clip reads on the populated side "
                        "of a one-sided SV [5] (v1.2.0 default; v1.2.3 "
                        "behavior = 0)")
    p.add_argument("-R", type=int, default=500, dest="max_repeat_depth",
                   help="drop breakpoints whose breakend depth reaches "
                        "this repetitive-coverage threshold [500] "
                        "(v1.2.0 flag; v1.2.3 removed the filter)")
    p.add_argument("--rescue", action="store_true",
                   help="emit unmapped clipped sequences to the rescue "
                        "fastq for iterative (virus-integration) calling; "
                        "the reference's rescue path is dead code and its "
                        "rescue fastq is always empty")
    p.add_argument("clip_bam")
    p.add_argument("original_bam")
    p.add_argument("clip_gz")
    p.add_argument("sv_out")
    p.add_argument("unmapped_fq_out")


def _add_somatic(sub):
    p = sub.add_parser("somatic", help="tumor/normal subtraction")
    p.add_argument("-t", type=float, default=0.85, dest="min_map_rate")
    p.add_argument("-q", type=int, default=20, dest="min_mapq")
    p.add_argument("-l", type=int, default=30, dest="offset")
    p.add_argument("-m", type=int, default=10, dest="min_len_of_clipped_seq")
    p.add_argument("-n", type=int, default=5_000_000, dest="read_pair_used")
    p.add_argument("normal_bam")
    p.add_argument("normal_clip_gz")
    p.add_argument("tumor_sv")
    p.add_argument("somatic_out")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="seeksv-tpu-torch",
        description="structural-variation and virus-integration detection "
                    "with the realignment kernels on a torch device")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser(
        "run", help="one-shot pipeline: getclip + aln + getsv [+ somatic]")
    pr.add_argument("-o", default="output", dest="prefix")
    pr.add_argument("--device", default="cuda",
                    help="torch device of the extension and finalize "
                         "kernels [cuda]; cpu runs their plain versions")
    pr.add_argument("--normal", default=None,
                    help="normal-sample BAM: also run somatic subtraction")
    pr.add_argument("--device-seed", action="store_true",
                    help="run seeding on the device against its k-mer table")
    pr.add_argument("--device-align", action="store_true",
                    help="full device front-end: seed + window gather + "
                         "extension on the device (ops.align_device)")
    pr.add_argument("--device-align-auto", action="store_true",
                    help="enable --device-align only where the committed "
                         "calibration (align/device_align_calibration.json) "
                         "measured a break-even")
    pr.add_argument("--rescue", action="store_true")
    pr.add_argument("--profile", default=None, dest="profile_dir",
                    help="write a torch.profiler trace of the run, with the "
                         "program's seeksv.* spans and counters, to "
                         "DIR/<prefix name>.trace.json (also with --stream)")
    pr.add_argument("--no-auto-calibrate", action="store_true",
                    help="skip the dispatch-calibration fingerprint check "
                         "(a stale calibration otherwise re-measures the "
                         "host/device crossover on first run)")
    pr.add_argument("--stream", action="store_true",
                    help="bounded-memory ingestion: decode each BAM once "
                         "in chunks (pipeline.stream)")
    pr.add_argument("--chunk-records", type=int, default=2_000_000,
                    help="records per decode slab with --stream")
    pr.add_argument("ref_fa")
    pr.add_argument("bam")
    pa = sub.add_parser("aln", help="realign clipped sequences (in-framework)")
    pa.add_argument("-k", type=int, default=19, dest="min_seed_len")
    pa.add_argument("-2", "--mate2", default=None, dest="mate2",
                    help="mate-2 fastq: paired-end mode (pair flags, mate "
                         "fields, FR proper-pair model)")
    pa.add_argument("--device", default="cuda",
                    help="torch device of the paired mode's extension and "
                         "finalize kernels [cuda]; cpu runs their plain "
                         "versions (single-end aln is the host aligner)")
    pa.add_argument("ref_fa")
    pa.add_argument("reads_fq")
    pa.add_argument("out_sam")
    _add_getclip(sub)
    _add_getsv(sub)
    _add_somatic(sub)
    pf = sub.add_parser("somatic-filter",
                        help="keep rows whose control columns are all 0")
    pf.add_argument("temp_sv")
    pf.add_argument("out_sv")
    pv = sub.add_parser("vcf", help="breakpoint file -> VCF BND records")
    pv.add_argument("breakpoint")
    pv.add_argument("template_vcf", nargs="?", default=None)
    pv.add_argument("out_vcf")
    pi = sub.add_parser("index", help="build a .bai index (samtools-index role)")
    pi.add_argument("bam")
    pw = sub.add_parser("view", help="records overlapping a region "
                        "(BAI-indexed, samtools-view role)")
    pw.add_argument("bam")
    pw.add_argument("region", help="chrom:beg-end (1-based)")
    pcl = sub.add_parser(
        "cluster", help="insert-size model (the reference's disabled "
                        "`cluster` subcommand, ref: seeksv.cpp:415-442)")
    pcl.add_argument("-n", type=int, default=5_000_000, dest="read_pair_used")
    pcl.add_argument("-q", type=int, default=20, dest="min_mapq")
    pcl.add_argument("bam")
    ps = sub.add_parser("simulate",
                        help="generate a truth-bearing synthetic dataset")
    ps.add_argument("-G", type=int, default=1_000_000, dest="genome_len")
    ps.add_argument("-c", type=float, default=30.0, dest="coverage")
    ps.add_argument("--dels", type=int, default=10)
    ps.add_argument("--invs", type=int, default=2)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("-o", default="sim", dest="prefix")
    pc = sub.add_parser("compare", help="compare SV result files")
    pc.add_argument("mode", choices=["simu", "crest", "seeksv"])
    pc.add_argument("-l", type=int, default=50, dest="fuzz")
    pc.add_argument("-n", dest="n_region_file", default=None)
    pc.add_argument("-t", action="store_true", dest="target_is_crest",
                    help="target file is in CREST format")
    pc.add_argument("-c", default="chr17", dest="chrom",
                    help="chromosome for simu truth [chr17]")
    pc.add_argument("--cnv", default=None, dest="cnv_file",
                    help="simu-mode CNV truth file (lins/ldel)")
    pc.add_argument("control")
    pc.add_argument("target")
    pc.add_argument("out_prefix")
    args = parser.parse_args(argv)

    if args.cmd == "getclip":
        from .pipeline.getclip import getclip
        getclip(args.bam, args.prefix, threshold=args.threshold,
                min_mapq=args.min_mapq, save_low_quality=args.save_low_quality)
    elif args.cmd == "getsv":
        if args.flank > 90 or args.flank < 0 or args.min_seq_len < 0:
            parser.error("-l must be in [0, 90] and -m >= 0")
        from .pipeline.getsv import getsv
        getsv(args.clip_bam, args.original_bam, args.clip_gz, args.sv_out,
              args.unmapped_fq_out, threshold=args.threshold, flank=args.flank,
              min_mapq=args.min_mapq, read_pair_used=args.read_pair_used,
              sum_min_both_clip=args.sum_min_both_clip,
              min_distance=args.min_distance, min_abnormal=args.min_abnormal,
              frequency=args.frequency,
              max_microhomology=args.max_microhomology,
              min_seq_len=args.min_seq_len,
              max_seq_indel_no=args.max_seq_indel_no,
              flank_length=args.flank_length, output_depth=not args.no_depth,
              temp_breakpoint=args.temp_breakpoint,
              connect_bam=args.connect_bam, connect_min_mapq=args.min_mapq2,
              rescue=args.rescue, rescue_mode=not args.no_rescue_mode,
              min_one_side_clip=args.min_one_side_clip,
              max_repeat_depth=args.max_repeat_depth,
              log=lambda *a: print(*a, file=sys.stderr))
    elif args.cmd == "somatic":
        if args.offset >= 90 or args.offset < 0:
            parser.error("-l must be in range [0, 90)")
        from .pipeline.somatic import somatic
        somatic(args.normal_bam, args.normal_clip_gz, args.tumor_sv,
                args.somatic_out, min_map_rate=args.min_map_rate,
                min_mapq=args.min_mapq, offset=args.offset,
                min_len_of_clipped_seq=args.min_len_of_clipped_seq,
                read_pair_used=args.read_pair_used)
    elif args.cmd == "somatic-filter":
        from .pipeline.somatic import somatic_filter
        somatic_filter(args.temp_sv, args.out_sv)
    elif args.cmd == "vcf":
        from .pipeline.vcf import breakpoint_to_vcf
        breakpoint_to_vcf(args.breakpoint, args.template_vcf, args.out_vcf)
    elif args.cmd == "index":
        from .io.bai import build_index
        print(build_index(args.bam), file=sys.stderr)
    elif args.cmd == "run":
        import torch
        if (torch.device(args.device).type == "cuda"
                and not args.no_auto_calibrate):
            # a stale fingerprint (another card, another upload rate)
            # re-measures the crossover on this card first
            from .align.engine import BatchAligner
            BatchAligner.ensure_calibration(
                auto=True, log=lambda *a: print(*a, file=sys.stderr))
        if args.device_align_auto:
            from .ops.align_device import device_align_auto_enabled
            args.device_align = device_align_auto_enabled()
            print(f"# --device-align-auto -> {args.device_align} "
                  "(align/device_align_calibration.json)", file=sys.stderr)
        kw = dict(device=args.device, normal_bam=args.normal,
                  device_seed=args.device_seed,
                  device_align=args.device_align,
                  log=lambda *a: print(*a, file=sys.stderr))
        if args.stream:
            from .pipeline.stream import run_pipeline_streaming
            res = run_pipeline_streaming(args.ref_fa, args.bam, args.prefix,
                                         chunk_records=args.chunk_records,
                                         profile_dir=args.profile_dir, **kw)
        else:
            from .pipeline.driver import run_pipeline
            res = run_pipeline(args.ref_fa, args.bam, args.prefix,
                               rescue=args.rescue,
                               profile_dir=args.profile_dir, **kw)
        print(json.dumps({"stages_s": res["stages_s"],
                          "aligner_s": res["aligner"].timings}),
              file=sys.stderr)
    elif args.cmd == "aln":
        if args.mate2:
            from .align.engine import align_paired_fastq_to_sam
            align_paired_fastq_to_sam(args.ref_fa, args.reads_fq, args.mate2,
                                      args.out_sam,
                                      min_seed_len=args.min_seed_len,
                                      device=args.device)
        else:
            from .align.engine import align_fastq_to_sam
            align_fastq_to_sam(args.ref_fa, args.reads_fq, args.out_sam,
                               min_seed_len=args.min_seed_len)
    elif args.cmd == "view":
        from .io.bai import view_region
        chrom, rng = args.region.split(":")
        b, e = (int(x) for x in rng.split("-"))
        try:
            for r in view_region(args.bam, chrom, b, e):
                print(f"{r['qname']}\t{r['flag']}\t{chrom}\t{r['pos'] + 1}\t"
                      f"{r['mapq']}\t{r['cigar']}\t{r['seq']}")
        except BrokenPipeError:
            import os
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    elif args.cmd == "simulate":
        import numpy as np
        from .utils.simulate import (build_donor, random_genome,
                                     simulate_reads, write_fasta)
        rng = np.random.default_rng(args.seed)
        G = args.genome_len
        ref = {"chrS": random_genome(rng, G)}
        # non-overlapping event slots across the genome
        n_ev = args.dels + args.invs
        margin = max(G // 20, 1000)
        slots = np.linspace(margin, G - margin - 3000, max(n_ev, 1))
        kinds = ["del"] * args.dels + ["inv"] * args.invs
        rng.shuffle(kinds)
        dels, invs = [], []
        for p, kind in zip(slots, kinds):
            ln = int(rng.integers(200, 3000))
            (dels if kind == "del" else invs).append((int(p), int(p) + ln))
        donor = build_donor(ref, deletions=dels, inversions=invs)
        write_fasta(f"{args.prefix}.ref.fa", ref)
        n = simulate_reads(donor, ["chrS"], [G], f"{args.prefix}.bam",
                           coverage=args.coverage, seed=args.seed)
        with open(f"{args.prefix}.truth.txt", "w") as f:
            for t in donor.truth:
                f.write("\t".join(str(x) for x in t) + "\n")
        print(f"wrote {args.prefix}.bam ({n} records), "
              f"{args.prefix}.ref.fa, {args.prefix}.truth.txt",
              file=sys.stderr)
    elif args.cmd == "cluster":
        from .io.bam import read_bam
        from .pipeline.getsv import calculate_insert_size
        recs = read_bam(args.bam)
        mean, dev = calculate_insert_size(recs, args.min_mapq,
                                          args.read_pair_used)
        print(f"Bam/sam {args.bam}    Mean insert size : {mean}\n"
              f"Mean deviation: {dev}", file=sys.stderr)
    elif args.cmd == "compare":
        from .pipeline.svcompare import compare
        compare(args.mode, args.control, args.target, args.out_prefix,
                fuzz=args.fuzz, n_region_file=args.n_region_file,
                target_is_crest=args.target_is_crest, chrom=args.chrom,
                cnv_file=args.cnv_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
