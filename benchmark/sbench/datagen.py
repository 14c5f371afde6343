"""Build one cell's dataset from its configuration, traffic and seed.

Run as a subprocess of ``benchmark/run.py`` so that the build's memory
never counts in the run's peak:

    python benchmark/sbench/datagen.py --config C.json --traffic T.json \
        --seed N --out DIR

Writes into ``DIR.building`` and renames it to ``DIR`` when done, with
``key.json`` naming what it was built from.  Prints one JSON line: the
paths, the record count and the build's seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from sbench.gen.dataset import build_dataset, build_somatic_dataset  # noqa: E402


def data_key(config: dict, traffic: dict, seed: int) -> dict:
    """What a dataset is built from: the configuration's sizes, the
    traffic's sample kind and the seed."""
    sizes = {k: config[k] for k in (
        "genome_bp", "coverage", "read_len", "insert_mean", "insert_sd",
        "error_rate", "n_events", "virus_bp", "virus_events", "virus_div")}
    return {"sizes": sizes, "sample": traffic["sample"], "seed": int(seed)}


def build(key: dict, root: str) -> dict:
    """Build the dataset ``key`` names under ``root``; returns its paths
    (``bams``: the tumour first) and ``truth``."""
    z = key["sizes"]
    for k, v in (("insert_sd", 25), ("error_rate", 0.002)):
        if z[k] != v:
            raise ValueError(f"the frozen generator fixes {k} at {v}")
    if z["insert_mean"] != max(500, 3 * z["read_len"]):
        raise ValueError("the frozen generator sets insert_mean to "
                         "max(500, 3 x read_len)")
    if key["sample"] == "pair":
        p = build_somatic_dataset(root, z["genome_bp"], z["coverage"],
                                  z["read_len"], key["seed"], z["n_events"])
        return {"ref_fa": p["ref_fa"], "bams": [p["tumor"], p["normal"]],
                "truth": p["truth"], "n_records": p["n_records"]}
    p = build_dataset(root, z["genome_bp"], z["coverage"], z["read_len"],
                      key["seed"], z["n_events"], False,
                      virus_kb=z["virus_bp"] // 1000,
                      virus_events=z["virus_events"],
                      virus_div=z["virus_div"])
    return {"ref_fa": p["ref_fa"], "bams": [p["bam"]], "truth": p["truth"],
            "n_records": p["n_records"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--key", required=True, help="data_key as JSON")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    key = json.loads(a.key)
    t = time.perf_counter()
    tmp = a.out + ".building"
    shutil.rmtree(tmp, ignore_errors=True)
    paths = build(key, tmp)
    with open(os.path.join(tmp, "key.json"), "w") as f:
        json.dump(key, f, sort_keys=True)
    meta = {"n_records": paths["n_records"],
            "seconds": time.perf_counter() - t}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(a.out, ignore_errors=True)
    os.rename(tmp, a.out)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
