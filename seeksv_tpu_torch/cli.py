"""Command line of the PyTorch port.

  python -m seeksv_tpu_torch run [-o prefix] [--device cuda] [--normal n.bam]
                                 [--device-seed] [--device-align]
                                 [--stream [--chunk-records N]]
                                 <ref.fa> <in.bam>

The other subcommands of ``python -m seeksv_tpu`` (getclip, getsv,
somatic, vcf, ...) run no device code; use them from there.
"""
from __future__ import annotations

import argparse
import json
import sys


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
    pr.add_argument("--stream", action="store_true",
                    help="bounded-memory ingestion: decode each BAM once "
                         "in chunks (pipeline.stream)")
    pr.add_argument("--chunk-records", type=int, default=2_000_000,
                    help="records per decode slab with --stream")
    pr.add_argument("ref_fa")
    pr.add_argument("bam")
    args = parser.parse_args(argv)

    if args.cmd == "run":
        kw = dict(device=args.device, normal_bam=args.normal,
                  device_seed=args.device_seed,
                  device_align=args.device_align,
                  log=lambda *a: print(*a, file=sys.stderr))
        if args.stream:
            from .pipeline.stream import run_pipeline_streaming
            res = run_pipeline_streaming(args.ref_fa, args.bam, args.prefix,
                                         chunk_records=args.chunk_records,
                                         **kw)
        else:
            from .pipeline.driver import run_pipeline
            res = run_pipeline(args.ref_fa, args.bam, args.prefix, **kw)
        print(json.dumps({"stages_s": res["stages_s"],
                          "aligner_s": res["aligner"].timings}),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
