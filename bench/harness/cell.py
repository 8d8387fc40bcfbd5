"""One cell of ``BENCHMARK.json``, and the files it names.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell's limits sits in a file of its own, found
here by the name that ``BENCHMARK.json`` gives:

- ``bench/configs/<config>.json``: the sizes as run, the port's config
  module that must hold the same values, the source, what was reduced
  and assumed, and under ``family`` the name of the model family;
- the family, two modules of that name (``bench.families``):
  ``bench/reference/families/<family>.py``, the plain reference of its
  layers and its weights' laws, and ``bench/counts/families/<family>.py``,
  its model FLOPs and kernel calls.  The reference and the counts find
  them by ``sizes["family"]``: :attr:`Cell.sizes` gives the file's
  ``sizes`` with ``family`` set to the file's top-level ``family`` (the
  port's own ``family`` field, which ``sizes`` holds in the file and
  :func:`port_config` checks, may name another: the port runs MLA as a
  dense family);
- ``bench/traffic/<traffic>.json``: the mix's parameters, and under
  ``kind`` the driver that runs it (``bench/drivers/<kind>.py``);
- ``bench/metrics/<metric>.py``: a per-layer metric's reader;
- ``bench/limits/<workload>.json``: the limit of each number that
  decides ``correct``, with the readings it was set from.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable

from bench import families

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # bench/configs/<config>.json
    traffic: dict             # bench/traffic/<traffic>.json
    limits: dict              # bench/limits/<workload>.json ({} if none)
    end_to_end: list[dict]    # the entries of BENCHMARK.json this cell reports
    per_layer: list[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def sizes(self) -> dict:
        """The sizes as the reference and the counts read them."""
        return {**self.config["sizes"], "family": self.family}

    def driver(self):
        return importlib.import_module(f"bench.drivers.{self.traffic['kind']}")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, spec_path: Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` and its files."""
    spec = _json(spec_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(ROOT / configs[w["config"]]["file"])
    families.reference(config["family"])     # both halves, or LookupError
    families.counts(config["family"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = _json(limits_path) if limits_path.exists() else {}
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])


def reader(metric: str) -> Callable[[Any], float | None]:
    """The ``read(record)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics._{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(config: dict):
    """The port's ``ModelConfig`` that the configuration's file names,
    checked against the file's sizes: a key that differs means the file
    no longer describes what runs."""
    mod = importlib.import_module(
        f"repro_torch.configs.{config['port_module']}")
    cfg = getattr(mod, config.get("port_attr", "CONFIG"))
    for key, want in config["sizes"].items():
        got = getattr(cfg, key)
        if got != want:
            raise ValueError(f"{config['port_module']}.{key} is {got!r}; "
                             f"the benchmark's file says {want!r}")
    return cfg
