"""One run of a cell: its dataset, the set-up, the measured window of
whole passes, the check that decides ``correct``, and the context the
metric readers read.

A pass is what ``python -m seeksv_tpu_torch run`` does for one sample:
``pipeline.driver.run_pipeline`` (traffic ``driver: whole``) or
``pipeline.stream.run_pipeline_streaming`` (``driver: stream``, with
the normal BAM for a pair), on the device, writing its outputs under
``TMPDIR``.  The program is imported only here, inside the functions
that drive it.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "seeksv_tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not hold, each
    compared whole (the part before the first dot)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def dataset(out: str, cell: dict, n_records: list) -> dict:
    """The paths of a dataset that datagen.py built into ``out``, with
    the HOME under which the program keeps its index of the fasta."""
    pair = cell["traffic"]["sample"] == "pair"
    bams = ["tumor.bam", "normal.bam"] if pair else ["sim.bam"]
    return {"ref_fa": os.path.join(out, "ref.fa"),
            "bams": [os.path.join(out, b) for b in bams],
            "truth": os.path.join(out, "truth.json"),
            "home": os.path.join(out, "home"),
            "n_records": n_records, "pair": pair}


def prepare_reference(data: dict) -> float:
    """Build the program's k-mer index of the dataset's fasta into its
    cache under ``data["home"]`` (the program keeps it under
    ~/.cache), in a process of its own, unless it is there: the
    reference that a deployment prepares once before it runs samples
    against it.  Each pass loads it from there, as ``run`` does.
    Returns the build's seconds (0 when it was there)."""
    done = os.path.join(data["home"], "index.done")
    if os.path.exists(done):
        return 0.0
    t = time.perf_counter()
    os.makedirs(data["home"], exist_ok=True)
    repo = os.path.dirname(os.path.dirname(HERE))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from seeksv_tpu_torch.align.engine import Aligner; "
         "Aligner.from_fasta(sys.argv[2])", repo, data["ref_fa"]],
        capture_output=True, text=True,
        env=dict(os.environ, HOME=data["home"]))
    if r.returncode:
        raise RuntimeError(f"the index build failed:\n{r.stderr}")
    open(done, "w").close()
    return time.perf_counter() - t


def ensure_data(bench_dir: str, cell: dict, seed: int, log) -> dict:
    """The cell's dataset for this seed, built by a subprocess into
    ``benchmark/.cache/data/<workload>`` unless that directory already
    holds it (it keeps only the newest seed), and the program's index of
    its fasta.  Returns its paths, the record counts and the builds'
    seconds (0 when they were kept)."""
    from sbench.datagen import data_key
    key = data_key(cell["config"], cell["traffic"], seed)
    out = os.path.join(bench_dir, ".cache", "data",
                       cell["workload"]["name"])
    kp = os.path.join(out, "key.json")
    built = 0.0
    have = None
    if os.path.exists(kp):
        with open(kp) as f:
            have = json.load(f)
    if have != key:
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, os.path.join(HERE, "datagen.py"), "--key",
             json.dumps(key), "--out", out], capture_output=True, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        if r.returncode:
            raise RuntimeError(f"the dataset's build failed:\n{r.stderr}")
        built = time.perf_counter() - t
    with open(os.path.join(out, "meta.json")) as f:
        data = dataset(out, cell, json.load(f)["n_records"])
    data["build_s"] = built
    data["index_s"] = prepare_reference(data)
    log(f"# data: {cell['workload']['name']} seed {seed}: "
        f"{sum(data['n_records'])} records "
        + (f"built in {built:.1f} s" if built else "kept from the last run")
        + (f", index built in {data['index_s']:.1f} s" if data["index_s"]
           else ", index kept"))
    return data


class Pass:
    """One whole-sample pass of the program, outputs at ``prefix``."""

    def __init__(self, cell: dict, data: dict, prefix: str, device: str):
        from seeksv_tpu_torch.pipeline import driver, stream
        self.driver, self.stream = driver, stream
        self.cell, self.data, self.prefix = cell, data, prefix
        self.device = device
        self.records = sum(data["n_records"])

    def clear(self) -> None:
        """Remove the last pass's outputs: a pass that writes nothing
        leaves nothing to judge."""
        d = os.path.dirname(self.prefix)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)

    def __call__(self) -> dict:
        tr = self.cell["traffic"]
        d = self.data
        if tr["driver"] == "whole":
            if d["pair"]:
                raise ValueError("driver whole takes one sample")
            r = self.driver.run_pipeline(d["ref_fa"], d["bams"][0],
                                         self.prefix, device=self.device)
        elif tr["driver"] == "stream":
            r = self.stream.run_pipeline_streaming(
                d["ref_fa"], d["bams"][0], self.prefix, device=self.device,
                chunk_records=tr["chunk_records"],
                normal_bam=d["bams"][1] if d["pair"] else None)
        else:
            raise ValueError(f"unknown driver {tr['driver']!r}")
        return r


class Recorder:
    """Spans around the calls into each layer, and the kernel calls of
    one pass, by wrapping module attributes of the program for the
    traced run; ``undo`` puts them back."""

    LAYERS = (("pipeline.driver", "read_bam", "bench.read_bam"),
              ("pipeline.driver", "getclip", "bench.getclip"),
              ("pipeline.driver", "realign_clips", "bench.realign"),
              ("pipeline.driver", "getsv", "bench.getsv"),
              ("pipeline.driver", "somatic", "bench.somatic"),
              ("pipeline.stream", "scan_bam", "bench.scan_bam"),
              ("pipeline.stream", "realign_clips", "bench.realign"),
              ("pipeline.stream", "getsv", "bench.getsv"),
              ("pipeline.stream", "somatic", "bench.somatic"))

    def __init__(self):
        import importlib

        import torch
        self.undos = []
        self.keep = False
        self.calls = {"extend": [], "banded": [], "walk": []}
        rf = torch.profiler.record_function
        for mod, attr, span in self.LAYERS:
            m = importlib.import_module(f"seeksv_tpu_torch.{mod}")
            fn = getattr(m, attr)

            def wrapped(*a, _fn=fn, _span=span, **kw):
                with rf(_span):
                    return _fn(*a, **kw)
            self._set(m, attr, wrapped)
        from seeksv_tpu_torch.ops import extend as ext
        from seeksv_tpu_torch.ops import global_device as gd
        ext_fn, band_fn, walk_fn = (ext.extend_batch_resident,
                                    gd.banded_direction, gd.traceback_rle)

        def extend(*a):
            if self.keep:
                self.calls["extend"].append(a)
            return ext_fn(*a)

        def banded(q, qlen, t, dlo, n, K):
            if self.keep:
                self.calls["banded"].append((qlen, n, K))
            return band_fn(q, qlen, t, dlo, n, K)

        def walk(dirs, m, n, dlo):
            out = walk_fn(dirs, m, n, dlo)
            if self.keep:
                self.calls["walk"].append((out[0], out[2], m, n))
            return out
        self._set(ext, "extend_batch_resident", extend)
        self._set(gd, "banded_direction", banded)
        self._set(gd, "traceback_rle", walk)

    def _set(self, mod, attr, fn):
        old = getattr(mod, attr)
        setattr(mod, attr, fn)
        self.undos.append(lambda: setattr(mod, attr, old))

    def undo(self):
        for u in reversed(self.undos):
            u()
        self.undos = []


def peak_rss_mb() -> float:
    """The process's peak resident memory (getrusage's ru_maxrss, kB on
    Linux), in MB of 1e6 bytes.  Subprocesses (the dataset's and the
    index's builds) never count.  It cannot be reset after set-up: the
    chip's machine refuses /proc/self/clear_refs."""
    import resource
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if kb <= 0:
        raise RuntimeError("getrusage gives no peak resident memory")
    return kb * 1024 / 1e6


def measure(cell: dict, data: dict, seconds: float, trace: bool,
            device: str, workdir: str, log) -> dict:
    """Set-up, then whole passes until ``seconds`` have elapsed, with
    the program's HOME at the dataset's (where its index is).  Returns
    the context the metric readers and the check read."""
    home = os.environ.get("HOME")
    os.environ["HOME"] = data["home"]
    try:
        return _measure(cell, data, seconds, trace, device, workdir, log)
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home


def _measure(cell, data, seconds, trace, device, workdir, log) -> dict:
    import torch
    t_setup = time.perf_counter()
    from seeksv_tpu_torch import _build
    from seeksv_tpu_torch.pipeline.driver import native_stage
    dev = torch.device(device)
    native_stage(dev, {})
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        _build.lib()
        torch.cuda.synchronize(dev)
    prefix = os.path.join(workdir, "out", "s")
    run = Pass(cell, data, prefix, device)
    run.clear()
    t = time.perf_counter()
    run()
    warm_s = time.perf_counter() - t
    setup_s = time.perf_counter() - t_setup
    log(f"# setup {setup_s:.3f} s (warm pass {warm_s:.3f})")
    rec = Recorder() if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    gc.collect()
    passes = []
    if prof is not None:
        prof.__enter__()
    try:
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                run.clear()
                if rec is not None:
                    rec.keep = not passes
                tp = time.perf_counter()
                with torch.profiler.record_function("bench.pass"):
                    r = run()
                passes.append({"stages_s": r["stages_s"],
                               "records": run.records,
                               "seconds": time.perf_counter() - tp})
                del r
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if rec is not None:
            rec.keep = False
            rec.undo()
    peak_rss = peak_rss_mb()
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    trace_path = None
    if prof is not None:
        trace_path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(trace_path)
        del prof
    log(f"# window {window_s:.3f} s, {len(passes)} passes: "
        + ", ".join(f"{p['seconds']:.3f}" for p in passes)
        + f"; peak RSS {peak_rss:.1f} MB (set-up and window)")
    for p in passes:
        log("# pass stages " + json.dumps(
            {k: round(v, 3) for k, v in p["stages_s"].items()}))
    from seeksv_tpu_torch.align import engine
    engine._PACKED_CACHE.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"passes": passes, "window_s": window_s, "setup_s": setup_s,
            "peak_rss_mb": peak_rss,
            "memory_peak_bytes": mem_peak, "trace_path": trace_path,
            "calls": rec.calls if rec is not None else None,
            "prefix": prefix, "device": device}


def check(cell: dict, data: dict, prefix: str, seed: int, device: str,
          control: bool = False, log=lambda *a: None) -> dict:
    """The numbers that decide ``correct``, each beside its limit:
    {name: {"value", "limit", "ok"}}.  With control, the
    narrow-arithmetic control's alignments stand in the program's place
    in aln_score_lost_pct, under the same limit (benchmark/proof.py
    reads it so; the benchmark's runs never do)."""
    import torch

    from sbench import judge
    g = judge.Genome(data["ref_fa"])
    dev = torch.device(device)
    table = judge.kmer_table(g, dev)
    bits = cell["config"]["score_bits"]
    cap = (1 << (bits // 2 - 1)) - 1 if control else None
    out = {}
    try:
        rows = judge.clip_rows(f"{prefix}.clip.gz")
        aln = judge.judge_alignments(g, table, rows, f"{prefix}.clip.sam",
                                     seed, dev, cap)
        got = judge.judge_outputs(prefix, data["truth"], data["pair"], rows)
    except FileNotFoundError as e:
        return {"outputs_present": {"value": 0, "limit": 1, "ok": False,
                                    "why": str(e)}}
    del table
    log(f"# judged {aln['judged']} of {aln['sampled']} sampled of "
        f"{aln['queries']} queries, {aln['unmapped_due']} of them unmapped "
        f"and {aln['missing_due']} without a record; the largest losses "
        + json.dumps(aln["worst"]))
    lim = cell["limits"]["aln_score_lost_pct_max"]
    lost = aln["control_lost_pct"] if control else aln["aln_score_lost_pct"]
    out["aln_score_lost_pct"] = {"value": lost, "limit": lim,
                                 "ok": lost <= lim}
    out["clip_sam_unmatched"] = {"value": aln["clip_sam_unmatched"],
                                 "limit": 0,
                                 "ok": aln["clip_sam_unmatched"] == 0}
    out["aln_judged"] = {"value": aln["judged"], "limit": 1,
                         "ok": aln["judged"] >= 1}
    gu = cell["config"]["guarantees"]
    for name, key in (("sv_recall", "sv_recall_min"),
                      ("clip_breakend_recall", "clip_breakend_recall_min"),
                      ("clip_at_events", "clip_at_events_min"),
                      ("somatic_recall", "somatic_recall_min")):
        if name in got:
            out[name] = {"value": got[name], "limit": gu[key],
                         "ok": got[name] >= gu[key]}
    if "germline_leaked" in got:
        out["germline_leaked"] = {
            "value": got["germline_leaked"],
            "limit": gu["germline_leaked_max"],
            "ok": got["germline_leaked"] <= gu["germline_leaked_max"]}
    return out
