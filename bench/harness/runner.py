"""One run of one cell: set-up, the window, the readers, the check, and
the result line.

:func:`run_cell` drives a run on any device (the tests drive it on the
CPU at a smoke size); ``bench/run.py`` is the command, which first
refuses a host without the chips the cell asks for.
"""
from __future__ import annotations

import math
import sys
import time

from bench.harness.cell import Cell, reader

#: top-level module names that must never be loaded in a run: JAX, its
#: libraries and the JAX package (compared whole: the port's name begins
#: with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a share of a roofline or of a peak above this is a fault of the count
SHARE_LIMIT = 105.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _build_kernels() -> None:
    """Build the LM kernels not built yet, all at once (the port's
    ``build_libraries``, which keys each library by its source's digest
    under ``build/repro_torch/`` in the checkout)."""
    from repro_torch.kernels import build
    names = ("flash_attention", "decode_attention", "fused_mlp")
    build.build_libraries([(n, build.CudaSource(n).source) for n in names])


def _device_info(torch, cell: Cell, device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}


def _judge(checks: dict, limits: dict) -> tuple[bool, dict, dict]:
    """(correct, each compared number beside its limit, the numbers the
    cell's limits file leaves uncompared).  A number is left uncompared
    only where the file says so (``"limit": null``, with the readings
    and the reason); one the file does not name fails, and so does a
    cell that compares nothing."""
    out, skipped, ok = {}, {}, True
    for name, value in checks.items():
        if name in limits and limits[name].get("limit") is None:
            skipped[name] = value
            continue
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(out), out, skipped


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: str | None = None) -> dict:
    """The result line of one run, as a dict (see ``bench/run.py``)."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    parts = {"start": time.perf_counter() - t_start}
    if device.type == "cuda":
        t = time.perf_counter()
        _build_kernels()
        parts["build"] = time.perf_counter() - t
    driver = cell.driver()
    marks = {}

    def window_opens():
        marks["setup_s"] = time.perf_counter() - t_start
    res = driver.run(cell, seed, seconds, trace, device, sync,
                     window_opens, control=control)
    correct, checks, uncompared = _judge(res["checks"], cell.limits)
    metrics = {}
    if trace:
        rec = res["record"]
        for m in cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**res["metrics"], "setup_s": marks["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": _device_info(torch, cell, device,
                                   res["memory_peak_bytes"])}
    if trace:
        from bench.harness.profile import breakdown, busy_s
        tr = res["record"].trace
        if tr is not None and tr.device:
            line["device"]["busy_s"] = busy_s(tr.device, tr.window)
            line["device"]["window_s"] = tr.window[1] - tr.window[0]
            line["breakdown"] = breakdown(tr.device, tr.host, tr.window)
    line["seconds"] = {"setup": marks["setup_s"], **parts,
                       **res["setup_parts"], **res["seconds"]}
    if "load" in res:
        line["load"] = res["load"]
    if uncompared:
        line["not_compared"] = uncompared
    if "trace_cost" in res:
        line["trace_cost"] = res["trace_cost"]
    if "control" in res:
        line["control"] = res["control"]
        # the control put in the program's place, under the cell's limits
        line["control_correct"] = _judge(
            {k: v for k, v in res["control"].items()
             if k != "altered_token"}, cell.limits)[0]
    line["checks"] = checks
    return line
