"""The encoder-decoder and vision-prefix families of the port, and the
``kv_repeat_to`` and ``attn_chunk`` options, against the JAX package on
the CPU.

whisper-base's and internvl2-26b's ``SMOKE`` configs (float32) with the
reference's parameters carried across by ``from_jax_params``, the
encoder's frames and the vision prefix drawn from a seed (normal, std 1:
zeros would leave the encoder's output, every cross-attention K and V and
the prefix rows all 0, and hide a wrong encoder); granite-3-2b's with
``kv_repeat_to = 2 * n_kv_heads``, and granite-3-2b's, minicpm3-4b's and
whisper-base's with ``attn_chunk`` at a ragged length (the plain route's
chunked scan, pad keys masked at -1e30): prefill logits and cache, then
decode steps with a scalar and a per-slot index, within 1e-5 *
max|logits|.  Also: the plain ``_chunked_attention`` against the
reference's, the new parameter subtrees carried bit for bit, admission
into slot 2 of a batcher whose slots hold seeded data, for a config of
each cache layout (dense, MLA, SSM, hybrid, encdec: ``enc_out`` along
axis 0), against the reference batcher's slot copy of the same prefill,
and into a slot a finished request left; internvl2's batcher (text-only,
as the reference's) against the reference's batcher, an encdec request
refused by both batchers (a ``Request`` has no frames), the step
builders passing the frontends through, and ``launch.serve``'s cache
sizing for a vision prefix longer than ``gen_len + 8``, where the
reference's own sizing overflows.

Tests marked ``gpu`` hold the kernels at the shapes these two models
put on the card (whisper's 1,500 ragged frames non-causal and in
cross-attention, decode attention with no bias over them, internvl2's
G = 6 at D = 128, the MLP at d 6144 / f 16384 and d 512 / f 2048)
against their plain versions, and whisper's lock-step captured step
against its eager step, bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher, Request  # noqa

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.batcher import Request as JRequest
except ImportError:
    jax = None

TOL = 1e-5                           # relative to max|logits|
# (label, arch, fields replaced in both packages' SMOKE config)
CASES = [
    ("whisper", "whisper_base", {}),
    ("internvl2", "internvl2_26b", {}),
    ("granite kv_repeat_to", "granite_3_2b", {"kv_repeat_to": 4}),
    ("granite attn_chunk", "granite_3_2b", {"attn_chunk": 3}),
    ("minicpm3 attn_chunk", "minicpm3_4b", {"attn_chunk": 3}),
    ("whisper attn_chunk", "whisper_base", {"attn_chunk": 8}),
]


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


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _pair(arch, fields, dtype="float32", seed=0):
    """(jax cfg, jax params, port cfg, port params)."""
    _needs_jax()
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype,
                              **fields)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype,
                               **fields)
    jp = JM.init(cfg, jax.random.PRNGKey(seed))
    tp = TM.from_jax_params(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tcfg, tp


def _frontend(cfg, B, seed=5):
    """The frontend inputs of ``cfg``'s family, normal with std 1:
    {name: numpy array}."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)
                            ).astype(np.float32)
    if cfg.family == "encdec":
        return {"enc_embeds": x}
    if cfg.family == "vlm":
        return {"extra_embeds": x}
    return {}


def _cache_leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], prefix + (k,))
        elif k != "index":
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("label,arch,fields", CASES,
                         ids=[c[0] for c in CASES])
def test_prefill_and_decode_match_the_reference(label, arch, fields):
    cfg, jp, tcfg, tp = _pair(arch, fields)
    B, S, max_len = 2, 7, 7 + cfg.n_frontend_tokens + 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    front = _frontend(cfg, B)
    jc = JM.init_cache(cfg, B, max_len, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, max_len, dtype=torch.float32, device="cpu")
    jl, jc = JM.prefill(jp, cfg, jnp.asarray(toks), jc,
                        **{k: jnp.asarray(v) for k, v in front.items()})
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                        **{k: torch.from_numpy(v) for k, v in front.items()})
    _close(tl, jl)
    paths = list(_cache_leaves(tc))
    assert paths == list(_cache_leaves(jc))
    for path in paths:
        _close(_get(tc, path), _get(jc, path))
    assert int(tc["index"]) == int(jc["index"]) == S + (
        cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    if fields.get("kv_repeat_to"):
        assert tc["attn"]["k"].shape[2] == fields["kv_repeat_to"]
    for _ in range(3):                       # scalar index (lock step)
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    lens = np.array([int(tc["index"]) + 1, 4], np.int32)   # per slot
    jc = {**jc, "index": jnp.asarray(lens)}
    tc = {**tc, "index": torch.from_numpy(lens)}
    for _ in range(2):
        t = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(t), jc)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(t), tc)
        _close(tl, jl)
    for path in paths:
        _close(_get(tc, path), _get(jc, path))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Sk, Dk, Dv, chunk): ragged keys, G > 1, Sq < Sk
    (2, 4, 2, 13, 13, 8, 8, 4),
    (1, 6, 1, 5, 30, 16, 8, 8),
    (2, 2, 2, 3, 17, 8, 8, 17),
    (1, 4, 4, 9, 9, 8, 8, 16),
], ids=["ragged-G2", "cross-G6", "one-chunk", "chunk>Sk"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_attention_matches_the_reference(shape, causal, with_bias):
    _needs_jax()
    B, Hq, Hkv, Sq, Sk, Dk, Dv, chunk = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((B, Hq, Sq, Dk)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, Dk)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, Dv)).astype(np.float32)
    bias = None
    if with_bias:
        bias = np.where(rng.random((B, Sk)) < 0.2, -1e30,
                        rng.standard_normal((B, Sk))).astype(np.float32)
        bias[:, -1] = 0.0                    # every causal row keeps a key
    want = JL._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal, chunk)
    got = TL._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), causal, chunk)
    _close(got, want)
    if bias is None and not (causal and Sq > Sk):
        # the same function as the oracle (the flash kernel's contract)
        _close(got, TR.flash_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal), 1e-5)


def test_new_subtrees_carry_across_bit_for_bit():
    cfg, jp, tcfg, tp = _pair("whisper_base", {}, dtype="bfloat16", seed=3)
    jn = jax.tree.map(np.asarray, jp)
    assert set(tp) == {"embed", "final_ln", "lm_head", "blocks",
                       "enc_blocks", "enc_final_ln", "cross_blocks"}
    n = 0
    for name in ("enc_blocks", "enc_final_ln", "cross_blocks"):
        for path in _cache_leaves({name: tp[name]}):
            a, b = _get(jn, path), _get(tp, path)
            assert a.dtype.name == "bfloat16" and b.dtype == torch.bfloat16
            assert np.array_equal(a.view(np.int16),
                                  b.view(torch.int16).numpy()), path
            n += 1
    assert n == 9 + 1 + 5            # enc attn 5 + mlp 4; norm; cross 5
    assert tp["enc_blocks"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
    assert tp["cross_blocks"]["wk"].shape[0] == cfg.n_layers
    with pytest.raises(ValueError, match="keys"):
        TM.from_jax_params(tcfg, {k: v for k, v in jn.items()
                                  if k != "cross_blocks"}, "cpu")


# (label, arch): a config of each cache layout
SLOT_CASES = [("dense", "granite_3_2b"), ("mla", "minicpm3_4b"),
              ("ssm", "mamba2_2p7b"), ("hybrid", "zamba2_1p2b"),
              ("encdec", "whisper_base")]


@pytest.mark.parametrize("arch", [c[1] for c in SLOT_CASES],
                         ids=[c[0] for c in SLOT_CASES])
def test_admission_writes_the_slot_the_reference_copies(arch, monkeypatch):
    """A 5-token prompt admitted into slot 2 of 3 slots that all hold
    seeded data: slot 2 ends as the reference batcher's after its
    ``_copy_slot`` of the same prefill (within 1e-5 * max|leaf|), the
    first token is the reference's, and slots 0 and 1 are untouched.
    Each leaf's declared ``batch`` axis is the one the reference copies
    along (0 for ``enc_out``, else 1).  An encdec prompt has no frames
    in a ``Request``; the port's prefill is given them here."""
    cfg, jp, tcfg, tp = _pair(arch, {})
    n_slots, max_len = 3, 16
    prompt = np.arange(3, 8, dtype=np.int32)
    front = _frontend(cfg, 1)
    jlogits, jone = JM.prefill(
        jp, cfg, jnp.asarray(prompt)[None],
        JM.init_cache(cfg, 1, max_len, dtype=jnp.float32),
        **{k: jnp.asarray(v) for k, v in front.items()})
    jb = JBatcher(cfg, jp, n_slots=n_slots, max_len=max_len)
    tb = ContinuousBatcher(tcfg, tp, n_slots=n_slots, max_len=max_len,
                           device="cpu")
    rng = np.random.default_rng(3)
    fill = {}
    for path in _cache_leaves(tb.cache):
        fill[path] = rng.standard_normal(
            _get(tb.cache, path).shape).astype(np.float32)
        _get(tb.cache, path).copy_(torch.from_numpy(fill[path]))
        _get(jb.cache, path[:-1])[path[-1]] = jnp.asarray(fill[path])
    jb._copy_slot(jone, 2)
    if front:
        monkeypatch.setattr(TM, "prefill", functools.partial(
            TM.prefill, **{k: torch.from_numpy(v) for k, v in front.items()}))
    req = Request(rid=0, prompt=prompt)
    tb._prefill(2, req)
    assert req.tokens == [int(jnp.argmax(jlogits[0]))]
    axes = TM.cache_axes(tb.cache)
    for path in _cache_leaves(tb.cache):
        got, want = _get(tb.cache, path), np.asarray(_get(jb.cache, path))
        a = 0 if path == ("enc_out",) else 1
        assert _get(axes, path).index("batch") == a
        assert len(_get(axes, path)) == got.dim() and got.shape[a] == n_slots
        _close(got.narrow(a, 2, 1), np.take(want, [2], axis=a))
        rest = torch.from_numpy(np.take(fill[path], [0, 1], axis=a))
        assert torch.equal(got.narrow(a, 0, 2), rest), path
        assert np.array_equal(np.take(want, [0, 1], axis=a), rest.numpy())
    if tcfg.use_mla:                 # the slot's two leaves: one buffer
        c, r = (TM.cache_slot(tb.cache, 2)["attn"][k]
                for k in ("c_kv", "k_rope"))
        assert r.data_ptr() == c.data_ptr() + c.shape[-1] * c.element_size()


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "minicpm3_4b"])
def test_admission_into_a_slot_a_finished_request_left(arch):
    """One slot serves a 9-token prompt for 6 tokens, then admits a
    4-token one: the positions past the new prompt read zero again, and
    every leaf (the hybrid's conv and SSM state among them) equals a
    fresh B = 1 prefill's, as does the first token."""
    cfg = tconfigs.get_smoke(arch)
    params = TM.init(cfg, 0, device="cpu")
    tb = ContinuousBatcher(cfg, params, n_slots=1, max_len=24, device="cpu")
    rng = np.random.default_rng(4)
    first, second = (Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=(n,)).astype(np.int32), max_new_tokens=6)
        for i, n in enumerate((9, 4)))
    tb.submit(first)
    tb.run_to_completion()
    assert first.done and tb.active == 0
    seq = {k: TM.cache_axes(tb.cache)["attn"][k].index("seq")
           for k in tb.cache["attn"]}
    for k, t in tb.cache["attn"].items():
        assert float(t.narrow(seq[k], 4, 20).abs().max()) > 0.0, k
    tb.submit(second)
    tb._admit()
    fresh = TM.init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu")
    logits, _ = TM.prefill(params, cfg, torch.from_numpy(second.prompt)[None],
                           fresh)
    assert second.tokens == [int(logits.argmax(-1))]
    for path in _cache_leaves(fresh):
        assert torch.equal(_get(tb.cache, path), _get(fresh, path)), path
    for k, t in tb.cache["attn"].items():
        assert float(t.narrow(seq[k], 4, 20).abs().max()) == 0.0, k


def test_vlm_batcher_matches_the_reference_batcher():
    """internvl2 served text-only, as the reference's batcher serves it:
    5 requests on 2 slots, the tokens equal and each step's logits
    within 1e-5 * max|logits|."""
    cfg, jp, tcfg, tp = _pair("internvl2_26b", {}, seed=2)
    jb = JBatcher(cfg, jp, n_slots=2, max_len=32)
    jlogits, jdecode = [], jb._decode

    def recorded(*a):
        out = jdecode(*a)
        jlogits.append(np.asarray(out[0]))
        return out
    jb._decode = recorded

    class Recorded(ContinuousBatcher):
        def _decode_step(self, tokens, lengths):
            out = super()._decode_step(tokens, lengths)
            tlogits.append(out[0])
            return out
    tlogits = []
    tb = Recorded(tcfg, tp, n_slots=2, max_len=32, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(5):
        prompt = rng.integers(0, cfg.vocab_size, size=(4 + i,)).astype(
            np.int32)
        jb.submit(JRequest(rid=i, prompt=prompt, max_new_tokens=3 + i))
        tb.submit(Request(rid=i, prompt=prompt, max_new_tokens=3 + i))
    jdone, tdone = jb.run_to_completion(), tb.run_to_completion()
    assert [r.tokens for r in tdone] == [r.tokens for r in jdone]
    assert len(tlogits) == len(jlogits) >= 8
    for got, want in zip(tlogits, jlogits):
        _close(got, want)


def test_an_encdec_request_is_refused_by_both_batchers():
    """A request carries no frames: the reference's prefill fails in its
    encoder, the port's names the missing ``enc_embeds``."""
    cfg, jp, tcfg, tp = _pair("whisper_base", {})
    prompt = np.arange(4, dtype=np.int32)
    jb = JBatcher(cfg, jp, n_slots=2, max_len=16)
    jb.submit(JRequest(rid=0, prompt=prompt))
    with pytest.raises(AttributeError):
        jb.step()
    tb = ContinuousBatcher(tcfg, tp, n_slots=2, max_len=16, device="cpu")
    tb.submit(Request(rid=0, prompt=prompt))
    with pytest.raises(ValueError, match="enc_embeds"):
        tb.step()


@pytest.mark.parametrize("arch", ["whisper_base", "internvl2_26b"])
def test_steps_pass_the_frontends_through(arch):
    cfg = tconfigs.get_smoke(arch)
    params = TM.init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(0))
    front = {k: torch.from_numpy(v) for k, v in _frontend(cfg, 2).items()}
    max_len = 5 + cfg.n_frontend_tokens + 4
    c1 = TM.init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    c2 = TM.init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    l1, c1 = tsteps.make_prefill_step(cfg)(params, {"tokens": toks, **front},
                                           c1)
    l2, c2 = TM.prefill(params, cfg, toks, c2, **front)
    assert torch.equal(l1, l2)
    t = l1.argmax(-1)
    l1, _ = tsteps.make_decode_step(cfg)(params, {"token": t}, c1)
    l2, _ = TM.decode_step(params, cfg, t, c2)
    assert torch.equal(l1, l2)
    # the frontend matters: zeros give other logits
    c3 = TM.init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    l3, _ = TM.prefill(params, cfg, toks, c3,
                       **{k: torch.zeros_like(v) for k, v in front.items()})
    assert not torch.allclose(l3, l2)


def test_encdec_prefill_checks_its_frames():
    cfg = tconfigs.get_smoke("whisper_base")
    params = TM.init(cfg, 0, device="cpu")
    toks = torch.zeros(1, 3, dtype=torch.long)
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        TM.prefill(params, cfg, toks, cache)
    with pytest.raises(ValueError, match="the cache holds"):
        TM.prefill(params, cfg, toks, cache,
                   enc_embeds=torch.zeros(1, 7, cfg.d_model))


def test_serve_sizes_the_cache_for_the_vision_prefix(monkeypatch, capsys):
    """A vision prefix of 40 with prompt 4 and gen 4: the reference's
    ``prompt + gen + 8`` = 16 positions cannot take the 44-position
    prefill (``dynamic_update_slice`` raises); the port's
    ``cache_len`` adds the prefix and serves."""
    _needs_jax()
    fields = {"n_frontend_tokens": 40}
    cfg = dataclasses.replace(jconfigs.get_smoke("internvl2_26b"), **fields)
    tcfg = dataclasses.replace(tconfigs.get_smoke("internvl2_26b"), **fields)
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="update shape"):
        JM.prefill(jp, cfg, jnp.zeros((1, 4), jnp.int32),
                   JM.init_cache(cfg, 1, 4 + 4 + 8, dtype=jnp.float32),
                   extra_embeds=jnp.zeros((1, 40, cfg.d_model)))
    assert serve.cache_len(tcfg, 4, 4) == 40 + 4 + 4 + 8
    assert serve.cache_len(tconfigs.get_smoke("whisper_base"), 4, 4) == 16
    monkeypatch.setattr(serve, "get_smoke", lambda arch: tcfg)
    out = serve.main(["--arch", "internvl2_26b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen-len", "4"])
    assert out["tokens"].shape == (2, 4)
    assert "OK" in capsys.readouterr().out


# ----------------------------------------------------------------------
# on the card: the kernels at these models' shapes
# ----------------------------------------------------------------------
def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def _card_close(got, want, tol):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


# bf16 outputs within two bfloat16 steps of the plain version
TOLS = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Sq, Sk, D, causal)
    (4, 8, 8, 1500, 1500, 64, False),      # whisper's encoder
    (4, 8, 8, 32, 1500, 64, False),        # whisper's cross prefill
    (4, 48, 8, 288, 288, 128, True),       # internvl2's prefill, G = 6
], ids=["whisper-encoder", "whisper-cross", "internvl2"])
def test_flash_matches_plain_on_card(shape, dtype):
    _needs_card()
    from repro_torch.kernels.flash_attention import flash_attention
    B, Hq, Hkv, Sq, Sk, D, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(Sk + Hq)
    q = _randn(gen, B, Sq, Hq, D, dtype=dtype).transpose(1, 2)
    k, v = (_randn(gen, B, Sk, Hkv, D, dtype=dtype).transpose(1, 2)
            for _ in range(2))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == n0 + 1
    _card_close(got, TR.flash_attention_ref(q, k, v, causal=causal),
                TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-cache", "bf16-cache"])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, S, D, lengths or None: no bias)
    (4, 8, 8, 72, 64, (33, 40, 51, 71)),    # whisper's self-attention
    (4, 8, 8, 1500, 64, None),              # whisper's cross-attention
    (4, 48, 8, 328, 128, (288, 300, 311, 327)),   # internvl2, G = 6
], ids=["whisper-self", "whisper-cross", "internvl2"])
def test_decode_matches_plain_on_card(shape, kv_dtype):
    _needs_card()
    from repro_torch.kernels.decode_attention import decode_attention
    B, Hq, Hkv, S, D, lens = shape
    gen = torch.Generator(device="cuda").manual_seed(S + Hq)
    q = _randn(gen, B, Hq, D)
    k, v = (_randn(gen, B, Hkv, S, D, dtype=kv_dtype) for _ in range(2))
    bias = None
    if lens is not None:
        keep = (torch.arange(S, device="cuda")[None]
                <= torch.tensor(lens, device="cuda")[:, None])
        bias = torch.where(keep, 0.0, -1e30)
        k = k.masked_fill(~keep[:, None, :, None], float("nan"))
    for qt in (q, q.to(torch.bfloat16)):
        got = decode_attention(qt, k, v, bias=bias)
        _card_close(got, TR.decode_attention_ref(
            qt, k.nan_to_num(0.0), v, bias=bias),
            TOLS[torch.float32 if qt.dtype == kv_dtype == torch.float32
                 else torch.bfloat16])
        assert torch.equal(got, decode_attention(qt, k, v, bias=bias))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (4, 6144, 16384), (1152, 6144, 16384),          # internvl2
    (4, 512, 2048), (128, 512, 2048), (6000, 512, 2048),   # whisper
], ids=["internvl2-T4", "internvl2-T1152", "whisper-T4", "whisper-T128",
        "whisper-T6000"])
def test_mlp_matches_plain_on_card(shape, dtype):
    _needs_card()
    from repro_torch.kernels.fused_mlp import fused_mlp, route
    T, d, f = shape
    gen = torch.Generator(device="cuda").manual_seed(T + d)
    x = _randn(gen, T, d, dtype=dtype)
    ws = [_randn(gen, d, dtype=dtype)] + [
        (_randn(gen, *s) * s[0] ** -0.5).to(dtype)
        for s in ((d, f), (d, f), (f, d))]
    which = route(dtype, T, d, f)
    assert which == ("simt" if dtype == torch.float32
                     else "stream" if T <= 8 else "tc")
    _card_close(fused_mlp(x, *ws), TR.fused_mlp_ref(x, *ws), TOLS[dtype])


@pytest.mark.gpu
def test_whisper_graph_logits_equal_the_eager_step_on_card():
    """Lock-step serving as ``launch.serve`` does it, with seeded frames:
    the captured step's logits equal the eager step's bit for bit, with
    12 decode-attention launches a step (6 self, 6 cross), none with a
    bias over the frames."""
    _needs_card()
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.runtime.compiled_step import CompiledStep
    cfg = dataclasses.replace(tconfigs.get_smoke("whisper_base"),
                              dtype="bfloat16")
    params = TM.init(cfg, 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, steps = 2, 6, 8
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    frames = torch.randn(B, cfg.n_frontend_tokens, cfg.d_model,
                         generator=gen, device="cuda")
    cache = TM.init_cache(cfg, B, S + steps + 8, dtype=torch.bfloat16,
                          device="cuda")
    logits, cache = TM.prefill(params, cfg, toks, cache, enc_embeds=frames)
    saved = {k: v.clone() for k, v in cache["attn"].items()}

    def decode_fn(tok, index):
        out, new = TM.decode_step(params, cfg, tok, {**cache,
                                                     "index": index})
        return out, new["index"]

    def run(step):
        for k, v in saved.items():
            cache["attn"][k].copy_(v)
        tok, index, outs = logits.argmax(-1), cache["index"], []
        for _ in range(steps):
            out, index = step(tok, index)
            outs.append(out)
            tok = out.argmax(-1)
        return outs

    graph = CompiledStep(decode_fn, device="cuda")
    decode_attention.launches = 0
    got = run(graph)
    assert decode_attention.launches == 2 * cfg.n_layers * steps
    want = run(lambda tok, index: decode_fn(tok, index))
    assert graph.captures == 1
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) == 0
