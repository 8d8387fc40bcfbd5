"""The port's dense LM against the JAX package's, on the CPU.

granite-3-2b's ``SMOKE`` config (float32, 2 layers) with the reference's
parameters carried across by ``from_jax_params``: prefill logits and
cache, then decode steps with a scalar and a per-slot cache index, agree
within 1e-5 * max|logits|.  The JAX side uses ``attn_impl="auto"``,
which on the CPU is its oracle path.  The port's own ``init`` follows
the declared laws; a config whose parameters exceed one card raises
``ValueError``, a mesh runs, and so does MLA's absorbed prefill.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.parallel.sharding import make_mesh, shard_tree  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import layers as JL
    from repro.models import model as JM
except ImportError:
    jax = None

TOL = 1e-5                           # relative to max|logits|
ARCH = "granite_3_2b"


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params) for the smoke config."""
    _needs_jax()
    cfg = jconfigs.get_smoke(ARCH)
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    tcfg = tconfigs.get_smoke(ARCH)
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tcfg, tp


def test_configs_are_copies_of_the_reference():
    _needs_jax()
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for name in jconfigs.ARCHS:
        for get in ("get_config", "get_smoke"):
            a = dataclasses.asdict(getattr(jconfigs, get)(name))
            b = dataclasses.asdict(getattr(tconfigs, get)(name))
            assert a == b, (name, get)
    assert tconfigs.get_config("granite-3-2b").n_params() == \
        jconfigs.get_config("granite-3-2b").n_params()


def test_prefill_and_decode_match_the_reference(pair):
    cfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["attn"][name], jc["attn"][name])
    assert int(tc["index"]) == int(jc["index"]) == 7
    for _ in range(3):                       # scalar index (lock step)
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["attn"][name], jc["attn"][name])
    lens = np.array([10, 6], np.int32)       # per-slot index vector
    jc = {**jc, "index": jnp.asarray(lens)}
    tc = {**tc, "index": torch.from_numpy(lens)}
    for _ in range(3):
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["attn"][name], jc["attn"][name])
    assert tc["index"].tolist() == [13, 9]


@pytest.mark.parametrize("shape", ["shared", "per_slot"])
def test_rope_matches_the_reference(shape):
    _needs_jax()
    rng = np.random.default_rng(3)
    if shape == "shared":
        x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
        pos = np.arange(9)
    else:
        x = rng.standard_normal((3, 1, 4, 64)).astype(np.float32)
        pos = np.array([[4], [40], [400]])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want)


def test_bfloat16_params_carry_across_bit_for_bit():
    _needs_jax()
    cfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke(ARCH), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JM.init(cfg, jax.random.PRNGKey(2)))
    tp = TM.from_jax_params(tcfg, jp, "cpu")
    a = jp["blocks"]["mlp"]["wg"]
    b = tp["blocks"]["mlp"]["wg"]
    assert a.dtype.name == "bfloat16" and b.dtype == torch.bfloat16
    assert np.array_equal(a.view(np.int16), b.view(torch.int16).numpy())
    with pytest.raises(ValueError, match="keys"):
        TM.from_jax_params(tcfg, {"embed": jp["embed"]}, "cpu")


def test_init_follows_the_declared_laws():
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), d_model=128,
                              d_ff=512, vocab_size=2048)
    params = TM.init(cfg, 0, device="cpu")
    defs = TM.param_defs(cfg)
    seen = 0
    for path, d in TL._leaves(defs):
        t = params
        for key in path:
            t = t[key]
        assert tuple(t.shape) == d.shape and t.dtype == torch.float32, path
        if d.init == "ones":
            assert torch.all(t == 1), path
        elif d.init == "zeros":
            assert torch.all(t == 0), path
        else:
            std = d.scale if d.scale is not None else d.shape[-2] ** -0.5
            assert abs(float(t.std()) / std - 1) < 0.05, path
            assert abs(float(t.mean())) < 0.05 * std, path
        seen += 1
    assert seen == 11                # embed, final_ln, 5 attn, 4 mlp
    again = TM.init(cfg, 0, device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    other = TM.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert not torch.equal(other["embed"], params["embed"])
    bf = TM.init(dataclasses.replace(cfg, dtype="bfloat16"), 0,
                 device="cpu")
    assert bf["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_what_is_not_ported_raises():
    # a mesh runs: the sharded prefill and decode steps on 2 x 2 of the
    # CPU give the unsharded steps' logits, and the launcher serves on it
    cfg = tconfigs.get_smoke(ARCH)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    params = TM.init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(0))
    cache = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    want, cache = tsteps.make_prefill_step(cfg)(params, {"tokens": toks},
                                                cache)
    sharded = shard_tree(TM.init_cache(cfg, 2, 8, dtype=torch.float32,
                                       device="cpu"),
                         tsteps.cache_shardings(cfg, ShapeConfig(
                             "s", 8, 2, "decode"), mesh))
    sp = shard_tree(params, serve.param_shardings(cfg, mesh))
    got, sharded = tsteps.make_prefill_step(cfg, mesh=mesh)(
        sp, {"tokens": toks}, sharded)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    tok = want.argmax(-1)
    want, _ = tsteps.make_decode_step(cfg)(params, {"token": tok}, cache)
    got, _ = tsteps.make_decode_step(cfg, mesh=mesh)(sp, {"token": tok},
                                                     sharded)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--mesh-data", "2"])
    assert out["mesh"] == {"data": 2, "model": 1}
    # 235 B parameters: no one card holds them, nor one card standing
    # for a mesh
    with pytest.raises(ValueError, match="model parallelism"):
        serve.main(["--arch", "qwen3_moe_235b_a22b", "--full", "--device",
                    "cpu"])
    # MLA's absorbed prefill runs: minicpm3's smoke config with
    # mla_absorb="always", prefill logits and cache against the
    # reference's within 1e-5 x max|ref| + 1e-5 x |ref| (the MLA tests'
    # tolerance, tests/test_torch_moe_mla.py)
    _needs_jax()
    jcfg = dataclasses.replace(jconfigs.get_smoke("minicpm3_4b"),
                               mla_absorb="always")
    tcfg = dataclasses.replace(tconfigs.get_smoke("minicpm3_4b"),
                               mla_absorb="always")
    jp = JM.init(jcfg, jax.random.PRNGKey(0))
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks),
                        JM.init_cache(jcfg, 2, 12, dtype=jnp.float32))
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks),
                        TM.init_cache(tcfg, 2, 12, dtype=torch.float32,
                                      device="cpu"))
    pairs = [(tl, jl)] + [(tc["attn"][n], jc["attn"][n])
                          for n in ("c_kv", "k_rope")]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert got.shape == want.shape
        tol = 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)
        assert np.all(np.abs(got - want) <= tol)
    # the absorbed form is the same function as the up-projected one
    up = dataclasses.replace(tcfg, mla_absorb="decode")
    tl_up, _ = TM.prefill(tp, up, torch.from_numpy(toks),
                          TM.init_cache(up, 2, 12, dtype=torch.float32,
                                        device="cpu"))
    assert float((tl - tl_up).abs().max()) <= 1e-4 * float(tl.abs().max())


def test_steps_are_the_model_calls():
    cfg = tconfigs.get_smoke(ARCH)
    params = TM.init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(0))
    c1 = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    c2 = TM.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    l1, c1 = tsteps.make_prefill_step(cfg)(params, {"tokens": toks}, c1)
    l2, c2 = TM.prefill(params, cfg, toks, c2)
    assert torch.equal(l1, l2)
    t = l1.argmax(-1)
    l1, _ = tsteps.make_decode_step(cfg)(params, {"token": t}, c1)
    l2, _ = TM.decode_step(params, cfg, t, c2)
    assert torch.equal(l1, l2)
