"""The port's SSM (mamba2) and hybrid (zamba2) LMs against the JAX
package's, on the CPU.

The ``SMOKE`` configs (float32) with the reference's parameters carried
across by ``from_jax_params``: prefill logits and caches (conv, SSM
state and the hybrid's attention sites), then decode steps with a scalar
and with a per-slot cache index, agree within 1e-5 * max|logits| (caches
within 1e-5 * their max).  The JAX side uses ``attn_impl="auto"``, which
on the CPU is its oracle path.  The port's own ``init`` keeps A and
dt_bias in float32 whatever the model's type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import layers as JL
    from repro.models import model as JM
except ImportError:
    jax = None

TOL = 1e-5                           # relative to max|logits| (or |cache|)
ARCHS = ("mamba2_2p7b", "zamba2_1p2b")


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def _pair(arch, key=0):
    _needs_jax()
    cfg = jconfigs.get_smoke(arch)
    jp = JM.init(cfg, jax.random.PRNGKey(key))
    tcfg = tconfigs.get_smoke(arch)
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tcfg, tp


def _caches(tc, jc):
    _close(tc["conv"], jc["conv"])
    _close(tc["ssm"], jc["ssm"])
    assert tc["ssm"].dtype == torch.float32
    if "attn" in jc:
        for name in ("k", "v"):
            _close(tc["attn"][name], jc["attn"][name])
    else:
        assert "attn" not in tc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    cfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(1)
    # 21 tokens: a chunk of 16 and a ragged one
    toks = rng.integers(0, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, 40, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 2, 40, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "attn"} == \
        {k: tuple(v.shape) for k, v in jc.items() if k != "attn"}
    jl, jc = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    _close(tl, jl)
    _caches(tc, jc)
    assert int(tc["index"]) == int(jc["index"]) == 21
    for _ in range(3):                       # scalar index (lock step)
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    _caches(tc, jc)
    lens = np.array([30, 25], np.int32)      # per-slot index vector
    jc = {**jc, "index": jnp.asarray(lens)}
    tc = {**tc, "index": torch.from_numpy(lens)}
    for _ in range(3):
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    _caches(tc, jc)
    assert tc["index"].tolist() == [33, 28]


def test_hybrid_cache_holds_one_attention_site_per_attn_every_layers():
    cfg = tconfigs.get_smoke("zamba2_1p2b")
    cache = TM.init_cache(cfg, 3, 12, device="cpu")
    sites = cfg.n_layers // cfg.attn_every
    assert tuple(cache["attn"]["k"].shape) == (sites, 3, cfg.n_kv_heads, 12,
                                               cfg.hd)
    full = tconfigs.get_config("zamba2_1p2b")
    assert full.n_layers // full.attn_every == 6


def test_causal_conv_and_decode_step_match_the_reference():
    """The conv carries its state across segments; the recurrent step
    updates the given states in place."""
    _needs_jax()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = JL._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if state is None else jnp.asarray(state))
        ty, ts = TL._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b),
                                 None if state is None
                                 else torch.from_numpy(state))
        _close(ty, jy)
        _close(ts, js)
    cfg, jp, tcfg, tp = _pair("mamba2_2p7b", key=3)
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["mamba"])
    tpl = {k: v[0] for k, v in tp["blocks"]["mamba"].items()}
    xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, cfg.conv_width - 1, cfg.d_inner
                            + 2 * cfg.ssm_state)).astype(np.float32)
    ssm = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state)).astype(np.float32)
    jo, jcv, jss = JL.mamba2_decode_step(p, cfg, jnp.asarray(xt),
                                         jnp.asarray(conv), jnp.asarray(ssm))
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    to, tcv, tss = TL.mamba2_decode_step(tpl, tcfg, torch.from_numpy(xt),
                                         tconv, tssm)
    assert tcv is tconv and tss is tssm                 # in place
    _close(to, jo)
    _close(tconv, jcv)
    _close(tssm, jss)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keeps_the_ssm_parameters_in_float32(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="bfloat16")
    params = TM.init(cfg, 0, device="cpu")
    m = params["blocks"]["mamba"]
    H = cfg.ssm_heads
    assert m["A"].dtype == m["dt_bias"].dtype == torch.float32
    assert m["in_proj"].dtype == torch.bfloat16
    assert tuple(m["A"].shape) == (cfg.n_layers, H)
    assert float(m["A"].max()) < -1.0 + 1e-6 and float(m["A"].min()) >= -16
    dt = torch.nn.functional.softplus(m["dt_bias"])    # uniform[1e-3, 1e-1)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert torch.all(m["D"] == 1) and torch.all(m["conv_b"] == 0)
    assert abs(float(m["conv_w"].float().std()) / 0.5 - 1) < 0.1
    assert (cfg.family == "hybrid") == ("shared_attn" in params)
    again = TM.init(cfg, 0, device="cpu")
    assert torch.equal(again["blocks"]["mamba"]["A"], m["A"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_params_carry_across_with_float32_ssm_leaves(arch):
    _needs_jax()
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JM.init(cfg, jax.random.PRNGKey(2)))
    tp = TM.from_jax_params(tcfg, jp, "cpu")
    for leaf, dtype in (("A", torch.float32), ("dt_bias", torch.float32),
                        ("in_proj", torch.bfloat16)):
        a, b = jp["blocks"]["mamba"][leaf], tp["blocks"]["mamba"][leaf]
        assert b.dtype == dtype, leaf
        if dtype == torch.float32:
            assert np.array_equal(a, b.numpy()), leaf
        else:
            assert np.array_equal(a.view(np.int16),
                                  b.view(torch.int16).numpy()), leaf
    if arch == "zamba2_1p2b":
        assert np.array_equal(jp["shared_mlp"]["wg"].view(np.int16),
                              tp["shared_mlp"]["wg"].view(torch.int16)
                              .numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_run_both_families(arch):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(0))
    c1 = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    c2 = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    l1, c1 = tsteps.make_prefill_step(cfg)(params, {"tokens": toks}, c1)
    l2, c2 = TM.prefill(params, cfg, toks, c2)
    assert torch.equal(l1, l2) and l1.shape == (2, cfg.vocab_size)
    t = l1.argmax(-1)
    l1, c1 = tsteps.make_decode_step(cfg)(params, {"token": t}, c1)
    l2, c2 = TM.decode_step(params, cfg, t, c2)
    assert torch.equal(l1, l2)
    assert torch.equal(c1["ssm"], c2["ssm"])
    assert bool(torch.isfinite(l1).all())
