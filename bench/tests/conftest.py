"""Fixtures of the benchmark's CPU tests: the repository and the port on
the path, one thread.  What the tests share is in ``bench_fixtures``."""
from __future__ import annotations

import sys

import pytest

from bench_fixtures import ROOT

for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    torch.set_num_threads(1)
    yield
