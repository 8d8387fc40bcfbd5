#!/usr/bin/env python3
"""Every memory-or-compute branch assignment of the cost-model fit.

The calibration fit (:func:`repro_torch.tune.calibrate.calibrate`) is
linear once each group's branch is decided, and its alternating active
set starts from the seed spec's branches.  This script tries every
assignment of the workloads in a drift log (one branch per signature,
``2 ** n`` of them) and solves each by the fit's weighted least squares,
then says whether the constants are physical (no negative time) and
consistent (each row on the branch the constants make the larger), with
the relative residual, Spearman and log10 bias of the re-predicted rows.
Runs on the CPU; no card needed.

Run:  python3 tools/fit_branches.py [tests/fixtures/torch_drift_h100.jsonl]
"""
from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.obs.drift import DriftRow, spearman  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "torch_drift_h100.jsonl"


def main() -> int:
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE
    rows = [DriftRow.from_dict(json.loads(line))
            for line in path.read_text().splitlines() if line.strip()]
    sigs = sorted({r.signature for r in rows})
    kinds = sorted({k for r in rows for g in r.features["groups"]
                    for k in g["ops_block"]})
    cols = ["waves", "memory"] + kinds
    measured = np.array([r.measured_s for r in rows])
    print(json.dumps({"rows": len(rows), "signatures": sigs,
                      "columns": cols}))
    for assign in itertools.product((True, False), repeat=len(sigs)):
        on_mem = {s: m for s, m in zip(sigs, assign)}
        terms = []                  # per row, per group: (w, mem, comp)
        A = np.zeros((len(rows), len(cols)))
        for i, r in enumerate(rows):
            w = 1.0 / r.measured_s
            groups = []
            for g in r.features["groups"]:
                mem = g["blocks"] * g["bytes_block"] / g["fill"]
                comp = {k: g["blocks"] * v / g["fill"]
                        for k, v in g["ops_block"].items()}
                groups.append((g["waves"], mem, comp))
                A[i, 0] += w * g["waves"]
                if on_mem[r.signature]:
                    A[i, 1] += w * mem
                else:
                    for k, v in comp.items():
                        A[i, 2 + kinds.index(k)] += w * v
            terms.append(groups)
        live = [j for j in range(len(cols)) if np.any(A[:, j] != 0.0)]
        sol = np.linalg.lstsq(A[:, live], np.ones(len(rows)), rcond=None)[0]
        theta = dict(zip((cols[j] for j in live), map(float, sol)))
        physical = all(v >= 0 for v in theta.values())
        consistent = True
        pred = []
        for r, groups in zip(rows, terms):
            t = 0.0
            for waves, mem, comp in groups:
                t_mem = mem * theta.get("memory", 0.0)
                t_comp = sum(v * theta.get(k, 0.0) for k, v in comp.items())
                consistent &= (t_mem >= t_comp) == on_mem[r.signature]
                t += max(t_mem, t_comp) + waves * theta["waves"]
            pred.append(t)
        pred = np.array(pred)
        ok = pred > 0
        print(json.dumps({
            "memory_branch": [s for s in sigs if on_mem[s]],
            "physical": physical, "consistent": bool(consistent),
            "theta": theta,
            "rel_residual_sq": float(np.sum(((pred - measured)
                                             / measured) ** 2)),
            "spearman": spearman(pred[ok], measured[ok]) if ok.sum() > 1
            else None,
            "log10_bias": float(np.median(np.log10(measured[ok]
                                                   / pred[ok])))
            if ok.any() else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
