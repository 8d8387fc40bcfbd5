"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

Every ``repro_torch`` module and everything ``chip_smoke.py`` imports
must load in a process where importing ``jax`` or ``ml_dtypes`` fails,
and must leave no ``repro`` module behind.  Entry points default to the card and raise
without one.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import apps as tapps               # noqa: E402
from repro_torch.core.compiler import compile_graph      # noqa: E402
from repro_torch.core.graph import as_inputs             # noqa: E402
from repro_torch.configs import get_smoke                # noqa: E402
from repro_torch.models import model as tmodel           # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.device import (DeviceUnavailableError,  # noqa: E402
                                resolve_device)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["ml_dtypes"] = None    # the card's machine has no ml_dtypes
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # its own imports, not its main()
chip_smoke_src = open(chip_smoke.__file__).read()
for line in chip_smoke_src.splitlines():
    line = line.strip()
    if line.startswith(("import repro_torch", "from repro_torch")):
        exec(line)
bad = sorted(m for m, mod in sys.modules.items()
             if m.split(".")[0] in ("repro", "jax", "ml_dtypes")
             and mod is not None)
print("modules", len(names))
print("bad", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_without_jax_or_repro():
    probe = _PROBE.format(src=str(SRC), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, env=_env(), cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "bad []" in res.stdout, res.stdout
    n = int(res.stdout.split("modules ")[1].split()[0])
    assert n >= 20


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")
    with pytest.raises(DeviceUnavailableError):
        tapps.compile_app("square", 16, 64)            # default device
    g = tapps.build_app("square", 16, 64)
    with pytest.raises(DeviceUnavailableError):
        compile_graph(g, device="cuda")
    with pytest.raises(DeviceUnavailableError):
        as_inputs(g, {"img": [[0.0] * 64] * 16}, None)
    cfg = get_smoke("granite_3_2b")
    with pytest.raises(DeviceUnavailableError):
        tmodel.init(cfg, 0)
    with pytest.raises(DeviceUnavailableError):
        tmodel.init_cache(cfg, 2, 16)
    params = tmodel.init(cfg, 0, device="cpu")
    with pytest.raises(DeviceUnavailableError):
        ContinuousBatcher(cfg, params, n_slots=2, max_len=16)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=_env(), cwd=ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
