"""The port's cost analysis against the JAX package's, on the CPU.

``repro_torch.analysis.hlo`` is a copy of the reference's HLO parser:
``shape_bytes``, ``collective_bytes`` and ``count_ops`` give the same
numbers on ``tests/test_analysis.py``'s fixture and on the text of a
real sharded module compiled on 8 forced host devices.
``repro_torch.analysis.roofline`` keeps the reference's fields and
arithmetic: ``model_flops`` and ``analyze`` equal the reference's for
every arch x shape under one explicit ``HW`` (the port's ``analyze``
takes the collective bytes as the parser's dict, not HLO text).  Its
default constants are one H100 SXM5 80GB's.  Exact equality throughout.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.analysis import hlo as thlo  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402

try:                                 # the card's machine has no JAX
    from repro import configs as jconfigs
    from repro.analysis import hlo as jhlo
    from repro.analysis import roofline as jroof
    from test_analysis import HLO_FIXTURE
except ImportError:
    jhlo = None


def _needs_jax():
    if jhlo is None:
        pytest.skip("needs JAX and the repro package")


@pytest.mark.parametrize("text", ["f32[16,128]", "bf16[4,8]{1,0}",
                                  "(bf16[2,2], u32[])", "pred[]",
                                  "(f32[3], s64[2,2], f8e4m3fn[7])",
                                  "c128[4]"])
def test_shape_bytes_matches_the_reference(text):
    _needs_jax()
    assert thlo.shape_bytes(text) == jhlo.shape_bytes(text)


def test_fixture_counts_match_the_reference():
    _needs_jax()
    assert thlo.collective_bytes(HLO_FIXTURE) == \
        jhlo.collective_bytes(HLO_FIXTURE)
    assert thlo.count_ops(HLO_FIXTURE) == jhlo.count_ops(HLO_FIXTURE)
    assert thlo.collective_bytes(HLO_FIXTURE)["ops"] == 5


_REAL_MODULE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4), ("d", "m"))
def f(x, w, v):
    y = jnp.tanh(x @ w)
    return (y @ v).sum(), y.mean(0)
x = jax.ShapeDtypeStruct((64, 512), jnp.float32)
w = jax.ShapeDtypeStruct((512, 256), jnp.bfloat16)
v = jax.ShapeDtypeStruct((256, 64), jnp.float32)
c = jax.jit(f, in_shardings=(NamedSharding(mesh, P("d", "m")),
                             NamedSharding(mesh, P("m", None)),
                             NamedSharding(mesh, P(None, "m"))),
            out_shardings=(NamedSharding(mesh, P()),
                           NamedSharding(mesh, P("m")))
            ).lower(x, w, v).compile()
print(c.as_text())
"""


def test_real_module_counts_match_the_reference():
    """A sharded module's optimized HLO, compiled on 8 forced host
    devices in a subprocess (the device count is fixed at JAX's first
    initialisation), read by both parsers."""
    _needs_jax()
    r = subprocess.run([sys.executable, "-c", _REAL_MODULE],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    text = r.stdout
    want = jhlo.collective_bytes(text)
    assert want["total"] > 0 and want["ops"] > 0, want
    assert thlo.collective_bytes(text) == want
    assert thlo.count_ops(text) == jhlo.count_ops(text)


def test_h100_constants():
    hw = troof.HW()
    assert hw == troof.H100_HW
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12,
                                                      50e9)
    assert not any("v5e" in n.lower() for n in dir(troof))


def test_model_flops_and_analyze_match_the_reference():
    """Every arch x shape, under one explicit HW for both packages: the
    model FLOPs, every field of the report, and the summary line."""
    _needs_jax()
    consts = dict(peak_flops=5e14, hbm_bw=2e12, link_bw=1e11)
    t_hw, j_hw = troof.HW(**consts), jroof.HW(**consts)
    coll = thlo.collective_bytes(HLO_FIXTURE)
    mem = {"argument_size_in_bytes": 123, "temp_size_in_bytes": 45}
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in tconfigs.ARCHS:
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for name, tshape in tconfigs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
            assert troof.model_flops(tcfg, tshape) == \
                jroof.model_flops(jcfg, jshape)
            for flops, byts in ((1e15, 1e12), (3e12, 9e13), (0.0, 5e9)):
                cost = {"flops": flops, "bytes accessed": byts}
                got = troof.analyze(arch, tshape, "pod", 256, cost, coll,
                                    mem, tcfg, hw=t_hw, note="n")
                want = jroof.analyze(arch, jshape, "pod", 256, cost,
                                     HLO_FIXTURE, mem, jcfg, hw=j_hw,
                                     note="n")
                assert got.row() == want.row(), (arch, name)
                assert got.summary() == want.summary()
