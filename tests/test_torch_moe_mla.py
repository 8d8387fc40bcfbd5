"""The MoE and MLA families of the port against the JAX package, on the
CPU: ``moe_block``, ``mla_attention_block``, the models and the batcher
at the ``SMOKE`` configs of granite-moe-3b-a800m, qwen3-moe-235b-a22b
and minicpm3-4b, with the reference's parameters carried across by
``from_jax_params``.

Tolerances: float32 within 1e-5 * max|ref| + 1e-5 * |ref| (summation
order only), the chosen experts equal.  In bfloat16 the expert products'
float32 sums are added in another order, so a y rounds to the
neighbouring bfloat16 now and then, and the combine adds in bfloat16:
within two bfloat16 steps, 2**-7 * max|ref| + 2**-7 * |ref|.  XLA on the
CPU has no bfloat16 product with a float32 result, so for those cases
``jnp.einsum`` is wrapped to upcast the operands first (exact: a bfloat16
product is exact in float32; the reference's semantics are unchanged).

The reference's Pallas ``decode_attention`` runs in interpret mode at
MLA's smoke shapes (Hkv 1, G 4, Dk 24, Dv 16) against the port's plain
version.  Tests marked ``gpu`` hold the kernel's latent instance against
its plain version at minicpm3-4b's and deepseek-v2-lite's shapes and
others (NaN in the masked keys, two calls compared bit for bit), over
biases with holes, and replayed in a CUDA graph while the lengths change.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher, Request  # noqa

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.kernels.decode_attention import decode_attention as j_decode
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.batcher import Request as JRequest
except ImportError:
    jax = None

MOE = ("granite_moe_3b_a800m", "qwen3_moe_235b_a22b")
ALL = MOE + ("minicpm3_4b",)
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CPU = torch.device("cpu")


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


def _close(got, want, rtol=1e-5):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = rtol * np.abs(want).max() + rtol * np.abs(want)
    assert np.all(err <= tol), float(err.max())


def _np(a):
    """A JAX array as float32 numpy (bfloat16 too)."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.fixture
def f32_einsum(monkeypatch):
    """``jnp.einsum`` with bfloat16 operands and a float32 result as the
    same product of the operands upcast (XLA's CPU lacks the former)."""
    _needs_jax()
    plain = jnp.einsum

    def einsum(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            args = [a.astype(jnp.float32) if hasattr(a, "dtype")
                    and a.dtype == jnp.bfloat16 else a for a in args]
        return plain(*args, preferred_element_type=preferred_element_type,
                     **kw)
    monkeypatch.setattr(jnp, "einsum", einsum)


def _pair(arch, dtype="float32", seed=0, **over):
    """(jax cfg, jax params, port cfg, port params) at the smoke config."""
    _needs_jax()
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype, **over)
    jp = JM.init(cfg, jax.random.PRNGKey(seed))
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), CPU)
    return cfg, jp, tcfg, tp


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ----------------------------------------------------------------------
# moe_block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_moe_block_matches_the_reference(arch, dtype, capacity, f32_einsum):
    """Output, aux and the chosen experts; capacity 0.5 forces every
    expert that gets more than half its share to drop tokens, and with
    it the reference's lost rank cap - 1 token."""
    cfg, jp, tcfg, tp = _pair(arch, dtype, capacity_factor=capacity)
    jp, tp = _layer0(jp["blocks"]["mlp"]), TM._layer(tp["blocks"]["mlp"], 0)
    rng = np.random.default_rng(5)
    for B, S in ((2, 9), (3, 1), (1, 33)):
        x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                        jnp.dtype(dtype))
        tx = _t(_np(x), TM.torch_dtype(dtype))
        jout, jaux = JL.moe_block(jp, cfg, x)
        tout, taux = TL.moe_block(tp, tcfg, tx)
        assert tout.dtype == tx.dtype and taux.dtype == torch.float32
        _close(tout, _np(jout), RTOL[dtype])
        _close(taux, _np(jaux), 1e-5)
        # the chosen experts: the reference's router, then top_k
        h = JL.rmsnorm(x, jp["ln"], cfg.norm_eps)
        gates = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", h.astype(jnp.float32),
            jp["router"].astype(jnp.float32)), axis=-1)
        jw, je = jax.lax.top_k(gates, cfg.experts_per_token)
        _, _, tw, te = TL.moe_route(tp, tcfg, tx)
        assert np.array_equal(te.numpy(), np.asarray(je))
        _close(tw, _np(jw / jw.sum(-1, keepdims=True)), 1e-5)


def test_moe_overflow_drops_like_the_reference():
    """A router that sends every token to experts 0 and 1: with T = 12
    tokens, K = 2, E = 8, capacity 0.5 gives cap 2, so both experts
    overflow; the rank-1 tokens lose their outputs too (the reference's
    last-write-wins scatter), and only the rank-0 token of each expert
    keeps one."""
    cfg, jp, tcfg, tp = _pair("granite_moe_3b_a800m", capacity_factor=0.5)
    jp = dict(_layer0(jp["blocks"]["mlp"]))
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 0], router[:, 1] = 5.0, 4.0
    jp["router"] = jnp.asarray(router)
    tp = dict(TM._layer(tp["blocks"]["mlp"], 0))
    tp["router"] = torch.from_numpy(router)
    x = np.abs(np.random.default_rng(1).standard_normal(
        (1, 12, cfg.d_model))).astype(np.float32)
    jout, _ = JL.moe_block(jp, cfg, jnp.asarray(x))
    tout, _ = TL.moe_block(tp, tcfg, torch.from_numpy(x))
    _close(tout, jout)
    moved = np.abs(np.asarray(jout) - x).max(-1)[0]
    assert (moved > 0).tolist() == [True] + [False] * 11


# ----------------------------------------------------------------------
# mla_attention_block
# ----------------------------------------------------------------------
def _mla_pair():
    cfg, jp, tcfg, tp = _pair("minicpm3_4b")
    return (cfg, _layer0(jp["blocks"]["attn"]), tcfg,
            TM._layer(tp["blocks"]["attn"], 0))


def test_mla_prefill_matches_the_reference():
    cfg, jp, tcfg, tp = _mla_pair()
    rng = np.random.default_rng(2)
    B, S, Smax = 2, 7, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jc = JL.decode_attn_cache(cfg, B, Smax, jnp.float32)
    tc = TL.decode_attn_cache(tcfg, B, Smax, torch.float32, CPU)
    pos = np.arange(S)
    jout, jc = JL.mla_attention_block(jp, cfg, jnp.asarray(x),
                                      jnp.asarray(pos), jc, 0)
    tout, tc = TL.mla_attention_block(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), tc, 0)
    _close(tout, jout)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name])
    assert float(tc["c_kv"][:, S:].abs().max()) == 0.0
    out, _ = TL.mla_attention_block(tp, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(pos))     # no cache
    assert torch.equal(out, tout)


@pytest.mark.parametrize("index", ["scalar", "per_slot"])
def test_mla_decode_matches_the_reference(index):
    """The absorbed form against a cache filled at random, written at a
    scalar or a per-slot index; the cache's contents too."""
    cfg, jp, tcfg, tp = _mla_pair()
    rng = np.random.default_rng(3)
    B, Smax = 3, 16
    r, kr = cfg.kv_lora_rank, cfg.rope_head_dim
    c_kv = rng.standard_normal((B, Smax, r)).astype(np.float32)
    k_rope = rng.standard_normal((B, Smax, kr)).astype(np.float32)
    jc = {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)}
    tc = TL.decode_attn_cache(tcfg, B, Smax, torch.float32, CPU)
    tc["c_kv"].copy_(torch.from_numpy(c_kv))
    tc["k_rope"].copy_(torch.from_numpy(k_rope))
    idx = (np.array(9, np.int32) if index == "scalar"
           else np.array([4, 15, 0], np.int32))
    pos = idx[None] if idx.ndim == 0 else idx[:, None]
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jout, jc = JL.mla_attention_block(jp, cfg, jnp.asarray(x),
                                      jnp.asarray(pos), jc, jnp.asarray(idx))
    tout, tc = TL.mla_attention_block(tp, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(pos), tc,
                                      torch.from_numpy(idx))
    _close(tout, jout)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name])


def test_latent_cache_is_one_buffer_and_survives_the_batcher():
    """``c_kv`` and ``k_rope`` are the column halves of one buffer, so the
    absorbed decode reads [c_kv ; k_rope] without a copy; the model's
    stacked cache and the batcher's slot copy keep that."""
    cfg = tconfigs.get_smoke("minicpm3_4b")
    r, kr = cfg.kv_lora_rank, cfg.rope_head_dim
    cache = TM.init_cache(cfg, 3, 10, dtype=torch.float32, device=CPU)
    c_kv, k_rope = cache["attn"]["c_kv"], cache["attn"]["k_rope"]
    assert c_kv.shape == (cfg.n_layers, 3, 10, r)
    assert k_rope.shape == (cfg.n_layers, 3, 10, kr)
    layer = TL._latent_rows(c_kv[1], k_rope[1])
    assert layer.data_ptr() == c_kv[1].data_ptr()        # a view
    k_rope[1, 2, 4] = 7.0
    assert float(layer[2, 4, r:].min()) == 7.0
    apart = TL._latent_rows(c_kv[1].clone(), k_rope[1].clone())
    assert torch.equal(apart, layer) and apart.data_ptr() != \
        layer.data_ptr()                                  # a copy
    b = ContinuousBatcher(cfg, TM.init(cfg, 0, device=CPU), n_slots=3,
                          max_len=16, device=CPU)
    b.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32) + 3,
                     max_new_tokens=4))
    b._admit()                            # prefills into slot 0
    one = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device=CPU)
    TM.prefill(b.params, cfg, torch.arange(5)[None] + 3, one)
    pool = b.cache["attn"]
    rows = pool["c_kv"][:, 0, :5]
    assert torch.equal(rows, one["attn"]["c_kv"][:, 0, :5])
    assert torch.equal(pool["k_rope"][:, 0, :5], one["attn"]["k_rope"][:, 0,
                                                                         :5])
    assert float(pool["c_kv"][:, 1:].abs().max()) == 0.0
    assert pool["k_rope"].data_ptr() == pool["c_kv"].data_ptr() + 4 * r
    b.step()                              # the decode step reads it
    assert b.decode_steps == 1 and len(b.slot_req[0].tokens) == 2


# ----------------------------------------------------------------------
# the models and the batcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL)
def test_prefill_and_decode_match_the_reference(arch):
    cfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jc = JM.init_cache(cfg, 2, 16, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 2, 16, dtype=torch.float32, device=CPU)
    jl, jc = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    _close(tl, jl)
    for step in range(6):           # 3 steps in lock step, 3 per slot
        if step == 3:
            lens = np.array([10, 6], np.int32)
            jc = {**jc, "index": jnp.asarray(lens)}
            tc = {**tc, "index": torch.from_numpy(lens)}
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    for name in jc["attn"]:
        _close(tc["attn"][name], jc["attn"][name])
    assert tc["index"].tolist() == [13, 9]


def test_expert_leaves_carry_across_bit_for_bit():
    cfg, jp, tcfg, tp = _pair("granite_moe_3b_a800m", "bfloat16", seed=4)
    for name in ("wg", "wu", "wd", "router"):
        a = np.asarray(jp["blocks"]["mlp"][name])
        b = tp["blocks"]["mlp"][name]
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(a.view(np.int16), b.view(torch.int16).numpy())
    assert tp["blocks"]["mlp"]["wg"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)


def test_qwen3_moe_batcher_matches_the_reference_batcher():
    """granite-moe and minicpm3 run in ``test_torch_decode_graph.py``."""
    cfg, jp, tcfg, tp = _pair("qwen3_moe_235b_a22b", seed=2)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(4 + i,)).astype(
        np.int32) for i in range(4)]
    jb = JBatcher(cfg, jp, n_slots=2, max_len=32)
    tb = ContinuousBatcher(tcfg, tp, n_slots=2, max_len=32, device=CPU)
    for i, p in enumerate(prompts):
        jb.submit(JRequest(rid=i, prompt=p, max_new_tokens=3 + i))
        tb.submit(Request(rid=i, prompt=p, max_new_tokens=3 + i))
    jdone, tdone = jb.run_to_completion(), tb.run_to_completion()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.tokens for r in tdone] == [r.tokens for r in jdone]


def test_expert_choices_record_and_replay():
    """``expert_choices`` records each ``moe_block`` call's own choices;
    replaying a run's choices gives its logits bit for bit, replaying
    other choices changes them while the record keeps the router's own
    (layer 0's are upstream of every MoE output, so unchanged); outside
    the ``with`` nothing is recorded."""
    cfg = tconfigs.get_smoke("granite_moe_3b_a800m")
    params = TM.init(cfg, torch.Generator().manual_seed(3), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 9)))

    def run(replay=None):
        cache = TM.init_cache(cfg, 2, 16, dtype=torch.float32, device=CPU)
        with TL.expert_choices(replay) as routing:
            logits, _ = TM.prefill(params, cfg, toks, cache)
        return logits, routing.chosen

    logits, chosen = run()
    assert len(chosen) == cfg.n_layers
    assert all(t.shape == (2, 9, cfg.experts_per_token) for t in chosen)
    same, again = run(chosen)
    assert torch.equal(same, logits)
    assert all(torch.equal(a, b) for a, b in zip(again, chosen))
    other = [(t + 1) % cfg.n_experts for t in chosen]
    moved, own = run(other)
    assert not torch.equal(moved, logits)
    assert torch.equal(own[0], chosen[0])
    assert TL._CHOICES is None
    cache = TM.init_cache(cfg, 2, 16, dtype=torch.float32, device=CPU)
    assert torch.equal(TM.prefill(params, cfg, toks, cache)[0], logits)


# ----------------------------------------------------------------------
# the kernel's plain version at MLA's shapes, and the route
# ----------------------------------------------------------------------
def test_plain_decode_matches_pallas_at_mla_shapes():
    """The plain version takes Dv != Dk with one KV head, as the Pallas
    kernel does (interpret mode), with a ragged length mask."""
    _needs_jax()
    rng = np.random.default_rng(7)
    B, G, Dk, Dv, S = 3, 4, 24, 16, 40
    q = rng.standard_normal((B, G, Dk)).astype(np.float32)
    rows = rng.standard_normal((B, 1, S, Dk)).astype(np.float32)
    lens = np.array([5, 39, 17])
    bias = np.where(np.arange(S)[None] <= lens[:, None], 0.0,
                    -1e30).astype(np.float32)
    want = j_decode(jnp.asarray(q), jnp.asarray(rows),
                    jnp.asarray(rows[..., :Dv]), bias=jnp.asarray(bias),
                    scale=0.3, interpret=True)
    got = DA.decode_attention(torch.from_numpy(q), torch.from_numpy(rows),
                              torch.from_numpy(rows)[..., :Dv],
                              bias=torch.from_numpy(bias), scale=0.3)
    assert got.shape == (B, G, Dv)
    _close(got, want)


def test_route_and_plan_of_the_latent_instance():
    assert DA.route(40, 1, 288, 256) == "mla"        # minicpm3-4b
    assert DA.route(24, 8, 64, 64) == "split"        # granite-moe
    assert DA.route(4, 1, 24, 16) == "split"         # the smoke MLA
    assert DA.route(64, 1, 320, 256) == "mla"
    assert DA.route(16, 1, 576, 512) == "mla"        # deepseek-v2-lite
    # past G 64, Dk 576 or Dv 512, Dv not a multiple of 8, Hkv > 1 past
    # the split instance's limits, or more shared memory than a block has
    for bad in ((65, 1, 288, 256), (40, 1, 580, 256), (40, 1, 288, 520),
                (40, 1, 288, 252), (40, 2, 288, 256), (6, 4, 64, 64),
                (64, 1, 576, 512)):
        assert DA.route(*bad) is None, bad
    # the host plan (the cut of the live rows is made on the device): two
    # blocks an SM at G <= 16 where two rings of two 16-key tiles fit,
    # else one with the deepest ring that fits
    p = DA.mla_plan(16, 576, 512, True, 2, 132)   # deepseek-v2-lite
    assert (p.blocks, p.stages, p.smem) == (264, 2, 103168)
    p = DA.mla_plan(16, 576, 512, True, 4, 132)   # a float32 q
    assert (p.blocks, p.stages, p.smem) == (132, 4, 195840)
    p = DA.mla_plan(40, 288, 256, True, 2, 132)   # minicpm3-4b
    assert (p.blocks, p.stages, p.smem) == (132, 4, 113920)
    p = DA.mla_plan(16, 576, 512, False, 4, 132)  # V rows of their own
    assert (p.blocks, p.stages, p.smem) == (132, 2, 188160)
    # every shape that route gives the latent instance fits a ring of two
    # tiles or more (the worst G of each 16-row tile of heads, a float32 q)
    for G in (16, 32, 48, 64):
        for Dk in range(8, DA.MLA_MAX_DK + 1, 8):
            for Dv in range(8, DA.MLA_MAX_DV + 1, 8):
                if DA.route(G, 1, Dk, Dv) != "mla":
                    continue
                for v_in_k in {False, Dv <= Dk}:
                    p = DA.mla_plan(G, Dk, Dv, v_in_k, 4, 132)
                    assert 2 <= p.stages <= DA.MLA_MAX_STAGES, (G, Dk, Dv)
                    assert p.blocks in (132, 264)
                    assert p.smem <= DA._MLA_SMEM, (G, Dk, Dv)
                    assert p.smem == DA.mla_smem_bytes(G, Dk, Dv, v_in_k, 4,
                                                       p.stages)
    # the scratch: 64 extents, then two partial states a run
    assert DA._mla_scratch_bytes(64, 16, 512, 264) == \
        512 + 4 * 2 * 264 * 16 * 514
    assert DA._mla_scratch_bytes(3, 40, 256, 2) == 32 + 4 * 2 * 2 * 40 * 258
    # q's shared-memory row: 4 mod 32 words in its own type
    assert DA._q_row(576, 2) == 584 and DA._q_row(288, 2) == 328
    assert DA._q_row(576, 4) == DA._smem_row(576) == 580
    assert DA._smem_row(288) == 292 and DA._smem_row(320) == 324
    assert DA._smem_row(24) == 36 and DA._smem_row(130) == 164


# ----------------------------------------------------------------------
# on the card: the latent instance at minicpm3-4b's shapes and others
# ----------------------------------------------------------------------
# name -> (G, Dk, Dv, cache dtype, S, slots' lengths): minicpm3-4b's
# served cache (ragged, every position live, one live key), then other
# shapes the latent instance takes (past G 16 or D 128; Dk 196 is padded
# to the tensor cores' depth of 8)
LATENT_SHAPES = {
    "minicpm3": (40, 288, 256, torch.float32, 512,
                 ((17, 130, 301, 511), (511,) * 4, (0,) * 4)),
    "G12 Dk196 Dv64": (12, 196, 64, torch.float32, 70, ((5, 69, 35),)),
    "G20 Dk136 Dv136 bf16 cache": (20, 136, 136, torch.bfloat16, 300,
                                   ((5, 299, 150),)),
    "G64 Dk320 Dv256": (64, 320, 256, torch.float32, 1000,
                        ((5, 999, 500),)),
    "G33 Dk288 Dv256 bf16 cache": (33, 288, 256, torch.bfloat16, 512,
                                   ((5, 511, 256),)),
    # the live extents the device-side cut has to handle: every slot at
    # one key; one slot at 1,919 with 63 at 5; lengths on and off the
    # 16-key tile's edges and 32's
    "deepseek-v2-lite": (16, 576, 512, torch.float32, 1920,
                         ((17, 330, 1200, 1919), (0, 1919, 5, 64), (0,) * 64,
                          (1919,) + (5,) * 63, (15, 16, 17, 31, 32, 33))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(LATENT_SHAPES))
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("joint", [True, False])
def test_latent_instance_matches_plain_on_card(shape, q_dtype, joint):
    """The latent instance (Hkv 1) at each of ``LATENT_SHAPES``; v a view
    of k's first Dv columns (the model's cache) or a tensor of its own;
    the masked keys hold NaN, so a read would show (the plain version
    reads them as 0); two calls, each one launch, equal bit for bit."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, Dk, Dv, cache_dtype, S, lengths = LATENT_SHAPES[shape]
    for lens in lengths:
        B = len(lens)
        rows = torch.randn(B, S, Dk, device="cuda", generator=gen)
        keep = torch.arange(S, device="cuda")[None] <= torch.tensor(
            lens, device="cuda")[:, None]
        bias = torch.where(keep, 0.0, -1e30)
        rows[~keep] = float("nan")
        rows = rows.to(cache_dtype)
        q = torch.randn(B, G, Dk, device="cuda", generator=gen).to(q_dtype)
        k, v = rows[:, None], rows[:, None, :, :Dv]
        v = v if joint else v.contiguous()
        want = TR.decode_attention_ref(q, torch.nan_to_num(k),
                                       torch.nan_to_num(v), bias=bias,
                                       scale=0.1)
        before = (DA.decode_attention.launches,
                  DA.decode_attention.mla_launches)
        got = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
        again = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
        torch.cuda.synchronize()
        assert (DA.decode_attention.launches,
                DA.decode_attention.mla_launches) == (before[0] + 2,
                                                      before[1] + 2)
        f32 = q_dtype == cache_dtype == torch.float32
        tol = 1e-5 if f32 else 8e-3     # float32 inputs; two bf16 steps
        assert float((got.float() - want.float()).abs().max()) <= \
            tol * float(want.float().abs().max())
        assert torch.equal(got, again)


def _holes(gen, B, S):
    """A (B, S) bias that is no prefix: each slot's live keys a random
    60 % of a window [first, last] (first past 0 mostly), some at -3; slot
    0 with no live key, slot 1 with only the last."""
    pos = torch.arange(S, device="cuda")[None]
    first = torch.randint(0, S // 2, (B, 1), device="cuda", generator=gen)
    last = first + torch.randint(0, S, (B, 1), device="cuda", generator=gen)
    u = torch.rand(B, S, device="cuda", generator=gen)
    keep = (pos >= first) & (pos <= last) & (u < 0.6)
    keep[0] = False
    keep[1] = pos[0] == S - 1
    return torch.where(keep, torch.where(u < 0.05, -3.0, 0.0), -1e30)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["deepseek-v2-lite", "minicpm3"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_latent_instance_over_holes_on_card(shape, q_dtype):
    """A bias that is not a prefix (``_holes``): masked keys inside each
    slot's extent hold NaN, so a read would show; a slot with no live key
    gives 0 (the plain version's masked rows are 0 there too); two calls
    equal bit for bit."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    G, Dk, Dv, cache_dtype, S, _ = LATENT_SHAPES[shape]
    B = 24
    bias = _holes(gen, B, S)
    rows = torch.randn(B, S, Dk, device="cuda", generator=gen)
    rows[bias <= -1e29] = float("nan")
    k, v = rows[:, None], rows[:, None, :, :Dv]
    q = torch.randn(B, G, Dk, device="cuda", generator=gen).to(q_dtype)
    want = TR.decode_attention_ref(q, torch.nan_to_num(k),
                                   torch.nan_to_num(v), bias=bias, scale=0.1)
    got = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
    again = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
    torch.cuda.synchronize()
    tol = 1e-5 if q_dtype == torch.float32 else 8e-3
    assert float((got.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())
    assert not got[0].any()
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_latent_instance_replays_in_a_graph_on_card():
    """The latent decode captured in a CUDA graph at deepseek-v2-lite's
    served shape (64 slots x 1920, bf16 q, v inside k's rows); between
    replays the rows, the lengths and the bias change (ragged prefixes,
    every slot at one key, one long slot among short ones, a bias with
    holes), NaN in the masked rows.  Each replay against the plain
    version and, bit for bit, against an eager call on the same inputs."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    G, Dk, Dv, _, S, _ = LATENT_SHAPES["deepseek-v2-lite"]
    B = 64
    rows = torch.randn(B, S, Dk, device="cuda", generator=gen)
    k, v = rows[:, None], rows[:, None, :, :Dv]
    q = torch.randn(B, G, Dk, device="cuda", generator=gen).to(torch.bfloat16)
    bias = torch.zeros(B, S, device="cuda")
    DA.decode_attention(q, k, v, bias=bias, scale=0.1)   # built, opted in
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
    pos = torch.arange(S, device="cuda")[None]
    ragged = torch.randint(0, 600, (B,), device="cuda", generator=gen)
    for lens in (ragged, (0,) * B, (1919,) + (5,) * (B - 1), None):
        if lens is None:
            new = _holes(gen, B, S)
        else:
            keep = pos <= torch.as_tensor(lens, device="cuda")[:, None]
            new = torch.where(keep, 0.0, -1e30)
        rows.copy_(torch.randn(B, S, Dk, device="cuda", generator=gen))
        rows[new <= -1e29] = float("nan")
        bias.copy_(new)
        graph.replay()
        eager = DA.decode_attention(q, k, v, bias=bias, scale=0.1)
        want = TR.decode_attention_ref(q, torch.nan_to_num(k),
                                       torch.nan_to_num(v), bias=bias,
                                       scale=0.1)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert float((out.float() - want.float()).abs().max()) <= \
            8e-3 * float(want.float().abs().max())
