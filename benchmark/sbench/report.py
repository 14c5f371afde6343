"""The run's result line, from the metric readers and the check."""
from __future__ import annotations

import os


def device_info(ctx: dict, trace) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s()
    return out


def result(spec, cell: dict, ctx: dict, checks: dict, traced: bool,
           log) -> dict:
    """The JSON object of the run's last line; the numbers compared go
    to standard error as its last lines too."""
    from sbench.trace import Trace
    trace = Trace(ctx["trace_path"]) if traced else None
    ctx = dict(ctx, trace=trace, kind=device_info(ctx, None)["kind"])
    group = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for m in group:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": len(ctx["passes"]), "failed": 0,
            "metrics": metrics, "device": device_info(ctx, trace)}
    if trace is not None:
        line["breakdown"] = {"device_ops": trace.top_ops(),
                             "idle_gaps": trace.idle_gaps()}
        os.remove(ctx["trace_path"])
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']}) "
            f"{'ok' if c['ok'] else 'FAILS'}")
    return line
