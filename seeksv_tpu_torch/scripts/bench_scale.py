"""The scale benchmark of the port: the whole pipeline on a simulated
dataset at the sizes the system's users run, on the card, with the
card's arm held against the native host arm in the same process.

Counterpart of scripts/bench_scale.py without its reference-binary arm,
which needs the reference's ``seeksv`` and ``bwa`` binaries:

    ours: io.read_bam (or one streamed decode) -> getclip -> realign on
          ``--device`` -> getsv

The dataset (``utils/dataset.build_dataset``: genome, sorted BAM + BAI,
truth) is cached under ``~/.cache/seeksv_tpu_torch/<key>`` and the k-mer
index beside it (``align.engine.Aligner.from_fasta``), both built before
the first trial, so repeated runs measure the pipeline, not the
simulator.  Prints one JSON row per run (``--ab``: one per arm) and
appends it to ``--out``.

``--ab``: per trial, back to back in one process, the ``device`` arm
(the calibrated dispatch on ``--device``) and the ``forced_host`` arm
(extension and finalize on the native host kernels; with
``--device-align`` the front-end stays on the card in both arms, as in
the JAX script); their ``.sv`` rows and decompressed ``.clip.gz`` /
``.clip.fq.gz`` must be identical, else the exit code is 1.

    python -m seeksv_tpu_torch.scripts.bench_scale [--genome-mb 10]
        [--coverage 30] [--read-len 100] [--seed 1] [--events 30]
        [--stream] [--ab] [--trials 3] [--device cuda] [--out PATH]

``--device`` defaults to ``cuda`` and raises on a host without a card;
``--device cpu`` runs the kernels' plain versions (small genomes only).
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import io
import json
import os
import resource
import sys
import tempfile
import time
import uuid

import numpy as np
import torch

from ..align.engine import BatchAligner
from ..io.bam import read_bam
from ..pipeline.driver import native_stage, realign_clips
from ..pipeline.getclip import GetclipStream, getclip
from ..pipeline.getsv import getsv
from ..pipeline.stream import StreamStats, scan_bam
from ..utils.dataset import build_dataset, sv_recall, sv_rows
from ._card import provenance, require, warm


RSS_NOTE = ("peak_rss_mb is ru_maxrss of the one process that runs every "
            "arm and trial, so with --ab it is the peak over both arms")


def cache_root(key: str) -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "seeksv_tpu_torch", key)


def dataset_key(G, coverage, read_len, seed, events, repeats=False,
                virus_kb=0, virus_events=0, virus_divergence=0.04) -> str:
    """The dataset's cache key, as scripts/bench_scale.py names it."""
    vtag = (f"-v{virus_kb}x{virus_events}d{virus_divergence}"
            if virus_kb else "")
    return (f"scale-G{G}-c{coverage}-l{read_len}-s{seed}-e{events}"
            f"{'-rep' if repeats else ''}{vtag}")


def run_ours(root, out_dir, device="cuda", stream=False,
             chunk_records=2_000_000, device_align=False, force_device=False,
             force_host=False):
    """The pipeline on ``root``'s sim.bam / ref.fa into ``out_dir/ours.*``:
    (records, stage seconds with the aligner's ``timings`` under
    "aligner" and its ``last_dispatch`` under "dispatch")."""
    dev = torch.device(device)
    native_stage(dev, {})
    bam = os.path.join(root, "sim.bam")
    ref_fa = os.path.join(root, "ref.fa")
    prefix = os.path.join(out_dir, "ours")
    stages = {}
    t0 = time.perf_counter()
    if stream:
        gs = GetclipStream(prefix)
        stats = StreamStats(20, 5_000_000)
        scan_bam(bam, chunk_records, [gs, stats])
        gs.close()
        n = stats.n
        stages["getclip_stream"] = time.perf_counter() - t0
        recs, stats_arg = None, stats
    else:
        recs = read_bam(bam)
        stages["read_bam"] = time.perf_counter() - t0
        t = time.perf_counter()
        getclip(bam, prefix, recs=recs)
        stages["getclip"] = time.perf_counter() - t
        n = recs.n
        stats_arg = None
    t = time.perf_counter()
    aligner = BatchAligner.from_fasta(ref_fa, device=dev)
    aligner.timings["index_load_s"] = time.perf_counter() - t
    realign_clips(ref_fa, f"{prefix}.clip.fq.gz", f"{prefix}.clip.sam",
                  aligner=aligner, device_align=device_align,
                  force_device=force_device, force_host=force_host)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages["realign"] = time.perf_counter() - t
    t = time.perf_counter()
    getsv(f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz", f"{prefix}.sv",
          f"{prefix}.r.fq", filtered_out=io.StringIO(), recs=recs,
          stats=stats_arg)
    stages["getsv"] = time.perf_counter() - t
    stages["total"] = time.perf_counter() - t0
    stages["aligner"] = {k: round(v, 3) for k, v in aligner.timings.items()}
    stages["dispatch"] = getattr(aligner, "last_dispatch", None)
    return n, stages


def bai_512mb_defect(ours_rows, ref_rows) -> bool:
    """True when two sv row lists differ exactly by the reference's BAI
    512 Mbp ceiling (PARITY.md §9): the same row count, every differing
    row differing only in column 10 (abnormal_read_pair_NO), with the
    reference's side 0 and up_pos >= 2^29.  For the reference-binary
    arm, which runs where its binaries are."""
    if len(ours_rows) != len(ref_rows):
        return False
    saw = False
    for a, b in zip(ours_rows, ref_rows):
        if a == b:
            continue
        fa, fb = a.split("\t"), b.split("\t")
        if len(fa) != len(fb):
            return False
        diffcols = [i for i in range(len(fa)) if fa[i] != fb[i]]
        if diffcols != [9] or fb[9] != "0" or int(fa[1]) < (1 << 29):
            return False
        saw = True
    return saw


def gz_sha(path):
    """sha256 of the decompressed stream (gzip container bytes differ
    between writers; byte parity is defined on the payload)."""
    h = hashlib.sha256()
    with gzip.open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _calls(rows):
    return sorted(tuple(r.split("\t")[:8]) for r in rows)


def _truth(root):
    with open(os.path.join(root, "truth.json")) as f:
        return json.load(f)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_cuda_mb(dev):
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 2 ** 20, 1)


def _row(args, n, st, totals, truth, rows, dev_info, setup, peak_cuda_mb):
    """The fields every row carries, from the best trial's stages `st`."""
    st = dict(st)
    al = st.pop("aligner", {})
    dispatch = st.pop("dispatch", None)
    dev_s = al.get("device_extend_s", 0.0) + al.get("device_finalize_s", 0.0)
    host_s = al.get("host_extend_s", 0.0)
    tr, vr = sv_recall(truth, rows)
    return {
        "metric": "scale_full_pipeline_reads_per_s",
        "value": round(n / st["total"], 1), "unit": "reads/s",
        "n_records": n, "genome_mb": args.genome_mb,
        "coverage": args.coverage, "read_len": args.read_len,
        "events": args.events, "seed": args.seed, "stream": args.stream,
        "chunk_records": args.chunk_records if args.stream else None,
        "device_align": args.device_align,
        "truth_del_recall": tr, "virus_junction_recall": vr,
        "virus": ({"kb": args.virus_kb, "events": args.virus_events,
                   "divergence": args.virus_divergence}
                  if args.virus_kb else None),
        "peak_rss_mb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "peak_cuda_mb": peak_cuda_mb,
        "ours_stages_s": {k: round(v, 3) for k, v in st.items()},
        "aligner_stages_s": al,
        "realign_device_fraction": round(
            dev_s / max(dev_s + host_s + al.get("seed_s", 0)
                        + al.get("finalize_s", 0), 1e-9), 4),
        "device_s_total": round(dev_s, 3),
        "device_fraction_total": round(dev_s / max(st["total"], 1e-9), 4),
        **dev_info,
        "dispatch": dispatch,
        "trials": max(1, args.trials),
        "ours_totals_s": totals,
        "ours_stddev_s": round(float(np.std(totals)), 3),
        "setup_s": setup,
        "note": RSS_NOTE,
    }


def _emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def run_ab(args, root, dev, setup=None) -> int:
    """Two arms in one process: per trial, back to back, ``device`` (the
    calibrated dispatch) and ``forced_host``, so that drift in the host's
    load hits both alike.  Emits one row per arm with the shared session
    summary; returns 1 unless both arms' sv rows and decompressed clip
    streams are identical."""
    arm_force = {"device": False, "forced_host": True}
    best = {k: None for k in arm_force}
    totals = {k: [] for k in arm_force}
    peak_cuda = {k: None for k in arm_force}
    svs, clip_sha = {}, {}
    n = None
    for t in range(max(1, args.trials)):
        for name, fh in arm_force.items():
            _reset_peak(dev)
            with tempfile.TemporaryDirectory() as d2:
                n, st = run_ours(root, d2, dev, stream=args.stream,
                                 chunk_records=args.chunk_records,
                                 device_align=args.device_align,
                                 force_host=fh)
                peak = _peak_cuda_mb(dev)
                if peak is not None:
                    peak_cuda[name] = max(peak_cuda[name] or 0.0, peak)
                totals[name].append(round(st["total"], 3))
                if best[name] is None or st["total"] < best[name]["total"]:
                    best[name] = st
                if t == 0:
                    p = os.path.join(d2, "ours")
                    svs[name] = sv_rows(f"{p}.sv")
                    clip_sha[name] = (gz_sha(f"{p}.clip.gz"),
                                      gz_sha(f"{p}.clip.fq.gz"))
        print(f"# trial {t + 1}/{args.trials}: "
              f"device {totals['device'][-1]}s, "
              f"forced_host {totals['forced_host'][-1]}s",
              file=sys.stderr, flush=True)
    truth = _truth(root)
    dev_info = provenance(dev)
    ab = {
        "session": uuid.uuid4().hex[:12],
        "trial_order": "interleaved per trial: device, forced_host (one "
                       "process)",
        "device_best_s": round(best["device"]["total"], 3),
        "forced_host_best_s": round(best["forced_host"]["total"], 3),
        "device_vs_forced_host": round(
            best["forced_host"]["total"] / best["device"]["total"], 4),
        "arms_sv_identical": svs["device"] == svs["forced_host"],
    }
    ok = ab["arms_sv_identical"]
    for name, other in (("device", "forced_host"), ("forced_host", "device")):
        parity = ("exact" if svs[name] == svs[other]
                  else ("calls-equal" if _calls(svs[name]) == _calls(
                      svs[other]) else "MISMATCH"))
        clip_parity = ("exact" if clip_sha[name] == clip_sha[other]
                       else "MISMATCH")
        row = _row(args, n, best[name], totals[name], truth, svs[name],
                   dev_info, setup, peak_cuda[name])
        row.update(arm=name, ab=ab, parity=parity, parity_of=other,
                   clip_parity=clip_parity,
                   clip_sha256=dict(zip(("clip.gz", "clip.fq.gz"),
                                        clip_sha[name])),
                   force_device_extend=False,
                   force_host_extend=arm_force[name])
        _emit(row, args.out)
        ok = ok and clip_parity == "exact"
    return 0 if ok else 1


def run_single(args, root, dev, setup=None) -> int:
    """Best of --trials runs of one configuration: one row."""
    best, totals, rows, n = None, [], None, None
    peak_cuda = None
    for t in range(max(1, args.trials)):
        _reset_peak(dev)
        with tempfile.TemporaryDirectory() as d2:
            n, st = run_ours(root, d2, dev, stream=args.stream,
                             chunk_records=args.chunk_records,
                             device_align=args.device_align,
                             force_device=args.force_device_extend,
                             force_host=args.force_host_extend)
            peak = _peak_cuda_mb(dev)
            if peak is not None:
                peak_cuda = max(peak_cuda or 0.0, peak)
            totals.append(round(st["total"], 3))
            if best is None or st["total"] < best["total"]:
                best = st
            if t == 0:
                rows = sv_rows(os.path.join(d2, "ours.sv"))
    row = _row(args, n, best, totals, _truth(root), rows, provenance(dev),
               setup, peak_cuda)
    row.update(parity="unchecked",
               force_device_extend=args.force_device_extend,
               force_host_extend=args.force_host_extend)
    _emit(row, args.out)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=float, default=10)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--events", type=int, default=30)
    ap.add_argument("--repeats", action="store_true",
                    help="copy repeat blocks into the genome")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--stream", action="store_true",
                    help="bounded-memory ingestion (pipeline.stream)")
    ap.add_argument("--chunk-records", type=int, default=2_000_000)
    ap.add_argument("--device-align", action="store_true",
                    help="the device-resident realignment front-end "
                         "(ops.align_device)")
    ap.add_argument("--force-device-extend", action="store_true",
                    help="send the extension rounds and the finalize to "
                         "the device past the calibrated crossovers")
    ap.add_argument("--force-host-extend", action="store_true",
                    help="keep the extension rounds and the finalize on "
                         "the native host kernels")
    ap.add_argument("--virus-kb", type=int, default=0,
                    help="add a virus contig of this many kb to the "
                         "reference and integrate divergent segments of "
                         "it into the donor (--virus-events sites)")
    ap.add_argument("--virus-events", type=int, default=0)
    ap.add_argument("--virus-divergence", type=float, default=0.04,
                    help="strain divergence between the integrated virus "
                         "segments and the reference virus contig")
    ap.add_argument("--ab", action="store_true",
                    help="two arms in one session: per trial the device "
                         "dispatch and the forced-host arm back to back; "
                         "one row per arm with a shared session summary "
                         "and the arms' sv and clip parity")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the kernels (cuda, or cpu for "
                         "their plain versions)")
    ap.add_argument("--out", default=None,
                    help="append the JSON rows to this file")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require(args.device)
    G = int(args.genome_mb * 1e6)
    root = cache_root(dataset_key(
        G, args.coverage, args.read_len, args.seed, args.events,
        args.repeats, args.virus_kb, args.virus_events,
        args.virus_divergence))
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    t0 = time.perf_counter()
    build_dataset(root, G, args.coverage, args.read_len, args.seed,
                  args.events, args.repeats, virus_kb=args.virus_kb,
                  virus_events=args.virus_events,
                  virus_div=args.virus_divergence, log=log)
    setup = {"dataset": round(time.perf_counter() - t0, 3)}
    warm(dev, setup)
    if dev.type == "cuda":
        # the crossovers were measured on one card: say whether they fit
        # this one, before any timed trial
        stale = BatchAligner.calibration_stale()
        log(f"# dispatch calibration: {stale or 'matches this card'}")
    # the k-mer index built (or loaded) outside the timed trials, as the
    # JAX script builds its bwa index with the dataset
    t0 = time.perf_counter()
    BatchAligner.from_fasta(os.path.join(root, "ref.fa"), device=dev)
    setup["index"] = round(time.perf_counter() - t0, 3)
    log(f"# dataset {setup['dataset']}s, index {setup['index']}s "
        f"(cached under {root})")
    if args.ab:
        return run_ab(args, root, dev, setup)
    return run_single(args, root, dev, setup)


if __name__ == "__main__":
    sys.exit(main())
