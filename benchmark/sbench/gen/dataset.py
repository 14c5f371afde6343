"""Frozen copy of seeksv_tpu_torch/utils/dataset.py at commit 08505b7.
Changes from the original: no BAI is written (no stage of the pipeline
reads one), the two BAMs of a pair are simulated in two processes at
once, a build returns its record counts (``n_records``), and the scoring
helpers moved to ``sbench.judge``.

Simulated datasets for the port's runs (no reference binaries needed).

``build_dataset`` is scripts/bench_scale.py:build_dataset without its
last step (copying the reference's seeksv/bwa binaries and building a bwa
index): a random host genome (``chr17``) plus an optional virus panel
(``virus``), DEL/INV events and virus integrations whose integrated
strain diverges from the panel, paired reads simulated into a sorted BAM
with its BAI, the reference fasta and the truth.  Everything comes from
``seed``.

The virus-integration flagship of the repo's scale benchmark is
``build_dataset(root, 40_000_000, 25, 1000, 1, 30, False, virus_kb=12_000,
virus_events=6_000, virus_div=0.04)``: 40 Mb host + 12 Mb panel, 25x,
1 kb reads, insert mean 3000, 6,000 integrations at 4 % divergence.

``build_somatic_dataset`` is scripts/bench_somatic_scale.py:build_dataset
without the same last step: a tumour / normal pair of BAMs over one
genome.  Here the two BAMs are simulated in two processes at once.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .simulate import (build_donor, mutate, random_genome, simulate_reads,
                       write_fasta)


def build_dataset(root, G, cov, read_len, seed, n_events, with_repeats,
                  virus_kb=0, virus_events=0, virus_div=0.04,
                  log=lambda *a: None) -> dict:
    """Write ``sim.bam``, ``ref.fa`` and ``truth.json`` under
    ``root``; a ``.done`` marker skips a finished build.  Returns the
    paths."""
    paths = {"bam": os.path.join(root, "sim.bam"),
             "ref_fa": os.path.join(root, "ref.fa"),
             "truth": os.path.join(root, "truth.json")}
    os.makedirs(root, exist_ok=True)
    done = os.path.join(root, ".done")
    if os.path.exists(done):
        return paths
    rng = np.random.default_rng(seed)
    g = random_genome(rng, G)
    if with_repeats:
        for _ in range(max(1, G // 2_000_000)):
            src = int(rng.integers(0, G - 20_000))
            dst = int(rng.integers(0, G - 20_000))
            ln = int(rng.integers(2_000, 15_000))
            g[dst:dst + ln] = g[src:src + ln]
    ref = {"chr17": g}
    margin = 50_000
    # one global slot array so del/inv intervals and virus insertion
    # points never overlap (build_donor requires disjoint sorted events)
    n_slots = max(n_events + virus_events, 1)
    slots = np.linspace(margin, G - margin - 10_000, n_slots)
    spacing = (G - 2 * margin - 10_000) / n_slots
    max_ev_len = int(min(5_000, max(spacing - 1_000, 300)))
    kinds = np.array(["sv"] * n_events + ["virus"] * virus_events)
    rng.shuffle(kinds)
    dels, invs, inss = [], [], []
    vtruth = []
    if virus_kb:
        virus = random_genome(rng, virus_kb * 1000)
        ref["virus"] = virus
        # the donor's integrated strain diverges from the panel contig
        vmut = mutate(rng, virus, virus_div)
        # disjoint panel slices per integration when the panel is big
        # enough, so no two host sites share virus sequence (an ambiguous
        # call two pipelines may resolve differently)
        vblock = 2_000
        if virus_kb * 1000 >= virus_events * vblock + vblock:
            vstarts = rng.permutation(virus_kb * 1000 // vblock - 1)[
                :virus_events] * vblock
        else:
            vstarts = None
        vi = 0
    for p, kind in zip(slots, kinds):
        if kind == "sv":
            ln = int(rng.integers(200, max_ev_len))
            (dels if rng.random() < 0.65
             else invs).append((int(p), int(p) + ln))
        else:
            vlen = int(rng.integers(500, 2_000))
            if vstarts is not None:
                voff = int(vstarts[vi])
                vi += 1
            else:
                voff = int(rng.integers(0, len(vmut) - vlen))
            inss.append((int(p), vmut[voff:voff + vlen]))
            # left junction chr17:p -> virus:voff(+); right junction
            # virus:voff+vlen -> chr17:p+1 (1-based breakends)
            vtruth.append({"type": "VINT", "up_chrom": "chr17", "up": int(p),
                           "down_chrom": "virus", "down": voff + 1,
                           "right_up": voff + vlen,
                           "right_down": int(p) + 1})
    donor = build_donor(ref, deletions=dels, inversions=invs,
                        insertions=inss)
    with open(paths["truth"], "w") as f:
        json.dump([{"type": t[0], "up_chrom": t[1], "up": int(t[2]),
                    "down_chrom": t[3], "down": int(t[4])}
                   for t in donor.truth if t[0] != "INS"] + vtruth, f)
    insert_mean = max(500, 3 * read_len)
    t0 = time.time()
    n = simulate_reads(donor, list(ref), [len(ref[c]) for c in ref],
                       paths["bam"], coverage=cov, seed=seed,
                       error_rate=0.002, read_len=read_len,
                       insert_mean=insert_mean)
    write_fasta(paths["ref_fa"], ref)
    log(f"# simulated {G / 1e6:g} Mbp + {virus_kb} kb virus x {cov} "
        f"({len(dels)} DEL, {len(invs)} INV, {len(inss)} integrations, "
        f"{n} records) in {time.time() - t0:.1f}s")
    open(done, "w").close()
    paths["n_records"] = [n]
    return paths


def build_somatic_dataset(root, G, cov, read_len, seed, n_events,
                          log=lambda *a: None) -> dict:
    """The tumour / normal pair of scripts/bench_somatic_scale.py:
    build_dataset, without its last step (the reference's binaries and a
    bwa index): one random genome (``chr17``), ``n_events`` deletions
    alternating germline and somatic; the tumour donor carries both, the
    normal donor the germline ones only, reads simulated from seed
    ``seed`` (tumour) and ``seed + 1`` (normal).  Writes ``tumor.bam``,
    ``normal.bam``, ``ref.fa`` and ``truth.json``
    (``somatic``: the somatic deletions' breakends, ``germline``: the
    germline deletions' intervals); a ``.done`` marker skips a finished
    build.  Returns the paths."""
    paths = {"tumor": os.path.join(root, "tumor.bam"),
             "normal": os.path.join(root, "normal.bam"),
             "ref_fa": os.path.join(root, "ref.fa"),
             "truth": os.path.join(root, "truth.json")}
    os.makedirs(root, exist_ok=True)
    done = os.path.join(root, ".done")
    if os.path.exists(done):
        return paths
    t0 = time.time()
    rng = np.random.default_rng(seed)
    g = random_genome(rng, G)
    ref = {"chr17": g}
    margin = 50_000
    slots = np.linspace(margin, G - margin - 10_000, max(n_events, 1))
    germline, somatic_only = [], []
    for i, p in enumerate(slots):
        ln = int(rng.integers(200, 5_000))
        (germline if i % 2 == 0 else somatic_only).append(
            (int(p), int(p) + ln))
    tumor = build_donor(ref, deletions=sorted(germline + somatic_only))
    normal = build_donor(ref, deletions=sorted(germline))
    # the somatic deletions' breakends (a donor of those alone gives them)
    som_truth = [(t[2], t[4]) for t in
                 build_donor(ref, deletions=sorted(somatic_only)).truth
                 if t[0] == "DEL"]
    with open(paths["truth"], "w") as f:
        json.dump({"somatic": som_truth, "germline": germline}, f)
    insert_mean = max(500, 3 * read_len)
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {name: pool.submit(simulate_reads, donor, ["chr17"], [G],
                                  paths[name], coverage=cov, seed=s,
                                  error_rate=0.002, read_len=read_len,
                                  insert_mean=insert_mean)
                for name, donor, s in (("tumor", tumor, seed),
                                       ("normal", normal, seed + 1))}
        n = {name: f.result() for name, f in futs.items()}
    write_fasta(paths["ref_fa"], ref)
    log(f"# simulated tumour / normal {G / 1e6:g} Mbp x {cov} "
        f"({len(germline)} germline, {len(somatic_only)} somatic DEL; "
        f"{n['tumor']} / {n['normal']} records) in {time.time() - t0:.1f}s")
    open(done, "w").close()
    paths["n_records"] = [n["tumor"], n["normal"]]
    return paths
