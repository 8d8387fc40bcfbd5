"""What the benchmark's CPU tests share: granite's cells at the port's
smoke size, with small mixes, driven on the CPU.  A module of its own
name, so that it is found beside another directory's ``conftest``."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMOKE_SIZES = {
    "granite": {"name": "granite3-smoke", "family": "dense", "n_layers": 2,
                "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
                "vocab_size": 256, "tie_embeddings": True,
                "dtype": "float32", "norm_eps": 1e-6,
                "rope_theta": 10000.0},
}
MODULES = {"granite": "granite_3_2b"}

SMOKE_GEN = {"kind": "serve", "slots": 4, "cache_positions": 64,
             "cache_dtype": "float32", "clients": 4,
             "prompt_tokens": {"law": "log_uniform", "min": 4, "max": 16},
             "output_tokens": {"law": "uniform", "min": 4, "max": 24},
             "warm_steps": 2, "check_sample": 3,
             "trace": {"start_share": 0.3, "max_steps": 6, "max_s": 2.0}}
SMOKE_TRAIN = {"kind": "train", "batch": 4, "seq_len": 16,
               "adamw": {"lr_peak": 3e-4, "lr_min": 3e-5, "warmup_steps": 100,
                         "decay_steps": 10000, "b1": 0.9, "b2": 0.95,
                         "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0},
               "check_steps": 3, "trace": {"after_steps": 1, "steps": 1}}


def smoke_cell(model: str, mix: str, limits: dict | None = None):
    """A cell of ``model`` ("granite") under the smoke ``mix`` ("gen" or
    "train"), with the metrics BENCHMARK.json gives that mix's cells."""
    from bench.harness.cell import Cell
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    like = {"gen": "granite-3-2b.gen", "train": "granite-3-2b.train"}[mix]

    def applies(m):
        return "workloads" not in m or like in m["workloads"]
    return Cell(name=like, chips=1,
                config={"family": SMOKE_SIZES[model]["family"],
                        "port_module": MODULES[model], "port_attr": "SMOKE",
                        "sizes": SMOKE_SIZES[model]},
                traffic=SMOKE_GEN if mix == "gen" else SMOKE_TRAIN,
                limits=limits or {},
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)])
