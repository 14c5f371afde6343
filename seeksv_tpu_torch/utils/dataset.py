"""Simulated datasets for the port's runs (no reference binaries needed).

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
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from ..io.bai import build_index
from .simulate import (build_donor, mutate, random_genome, simulate_reads,
                       write_fasta)


def build_dataset(root, G, cov, read_len, seed, n_events, with_repeats,
                  virus_kb=0, virus_events=0, virus_div=0.04,
                  log=lambda *a: None) -> dict:
    """Write ``sim.bam`` (+ ``.bai``), ``ref.fa`` and ``truth.json`` under
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
    build_index(paths["bam"])
    write_fasta(paths["ref_fa"], ref)
    log(f"# simulated {G / 1e6:g} Mbp + {virus_kb} kb virus x {cov} "
        f"({len(dels)} DEL, {len(invs)} INV, {len(inss)} integrations, "
        f"{n} records) in {time.time() - t0:.1f}s")
    open(done, "w").close()
    return paths


def truth_recall(truth_path: str, sv_path: str):
    """(DEL recall, virus-junction recall or None) of an ``.sv`` file
    against ``truth.json``: a call matches a truth breakpoint pair when
    both breakends lie within 50 bp on the same chromosomes (the
    reference's merge window); an integration has two junctions
    (host -> virus and virus -> host).  As scripts/bench_scale.py:
    sv_recall."""
    with open(truth_path) as f:
        truth = json.load(f)
    calls = []
    with open(sv_path) as f:
        for line in f:
            if not line.startswith("@"):
                fl = line.split("\t")
                calls.append((fl[0], int(fl[1]), fl[4], int(fl[5])))
    cu = np.asarray([c[1] for c in calls], np.int64)
    cd = np.asarray([c[3] for c in calls], np.int64)

    def hit(up_chrom, up, down_chrom, down):
        near = (np.abs(cu - up) <= 50) & (np.abs(cd - down) <= 50)
        return any(calls[i][0] == up_chrom and calls[i][2] == down_chrom
                   for i in np.nonzero(near)[0])

    dels = [t for t in truth if t["type"] == "DEL"]
    del_recall = round(sum(hit(t["up_chrom"], t["up"], t["down_chrom"],
                               t["down"]) for t in dels)
                       / max(len(dels), 1), 4)
    vints = [t for t in truth if t["type"] == "VINT"]
    if not vints:
        return del_recall, None
    vhit = sum(hit(t["up_chrom"], t["up"], t["down_chrom"], t["down"])
               + hit(t["down_chrom"], t["right_up"], t["up_chrom"],
                     t["right_down"]) for t in vints)
    return del_recall, round(vhit / (2 * len(vints)), 4)
