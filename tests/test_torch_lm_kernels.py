"""The LM kernels of the port: plain versions against the JAX package,
and the Hopper kernels against their plain versions.

On the CPU the wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); these are held against the Pallas kernels
in interpret mode (as ``tests/test_kernels.py`` runs them) and against
``repro.kernels.ref``, at small shapes, float32, within
1e-5 * max|ref| + 1e-5 * |ref|.  At ragged causal lengths (S = 100,
200) only the oracle is the reference: the Pallas kernel offsets its
causal mask by the padded lengths and is wrong at S = 100 (ROADMAP §C).

Tests marked ``gpu`` build each kernel with nvcc and hold it against its
plain version on the card at granite-3-2b's shapes: float32 operands
within 1e-5 * max|plain|, the serving path's types (bfloat16 out)
within 8e-3 * max|plain| (two bfloat16 steps).  They skip without a
card; the JAX parity tests skip where JAX is missing.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.device import DeviceUnavailableError  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import route as flash_route  # noqa: E402
from repro_torch.kernels.fused_mlp import (BLOCK_F, SMEM_LIMIT,  # noqa: E402
                                           STREAM_MAX_T, MlpPlan, TcPlan,
                                           fused_mlp, plan, smem_bytes,
                                           stream_smem_bytes, tc_plan,
                                           tc_smem_bytes)
from repro_torch.kernels.fused_mlp import route as mlp_route  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax.numpy as jnp
    from repro.kernels import ref as JR
    from repro.kernels.decode_attention import decode_attention as j_decode
    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.kernels.fused_mlp import fused_mlp as j_mlp
except ImportError:
    jnp = None

RTOL = 1e-5                          # relative to max|ref| and to |ref|


def _needs_jax():
    if jnp is None:
        pytest.skip("needs JAX and the repro package")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pad_bias(B, S, lens):
    keep = np.arange(S)[None] < np.asarray(lens)[:, None]
    return np.where(keep, 0.0, -1e30).astype(np.float32)


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,with_bias", [
    (1, 4, 4, 128, 64, True, False),      # G = 1
    (2, 8, 2, 256, 64, True, False),      # G = 4
    (1, 4, 1, 256, 128, True, False),     # MQA
    (2, 8, 2, 200, 64, False, False),     # ragged, not causal
    (2, 4, 1, 256, 64, False, True),      # G = 4, padding bias
])
def test_flash_plain_matches_pallas_interpret(B, Hq, Hkv, S, D, causal,
                                              with_bias):
    _needs_jax()
    rng = np.random.default_rng(S + Hq)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    bias = _pad_bias(B, S, rng.integers(S // 2, S, B)) if with_bias else None
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   bias=None if bias is None else jnp.asarray(bias),
                   causal=causal, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v),
                          bias=None if bias is None else _t(bias),
                          causal=causal)
    _close(got, want)


@pytest.mark.parametrize("S", [100, 200])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_plain_matches_oracle_at_ragged_causal_lengths(S, G):
    """The Pallas kernel's causal offset is the padded lengths' (ROADMAP
    §C); the port's follows the oracle at every length."""
    _needs_jax()
    rng = np.random.default_rng(S * G)
    B, Hkv, D = 2, 2, 64
    q = rng.standard_normal((B, Hkv * G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    want = np.asarray(JR.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=True)
    _close(got, want)
    if S == 100 and G == 1:          # the reference kernel's fault, shown
        pallas = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    interpret=True))
        assert np.abs(pallas - want).max() > 1e-2


def test_flash_plain_matches_oracle_with_fewer_queries_than_keys():
    """Queries sit at the end of the keys: query i sees i + Sk - Sq."""
    _needs_jax()
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 37, 64)).astype(np.float32)
    k = rng.standard_normal((1, 2, 90, 64)).astype(np.float32)
    v = rng.standard_normal((1, 2, 90, 32)).astype(np.float32)   # Dv != Dk
    want = JR.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, scale=0.2)
    _close(flash_attention(_t(q), _t(k), _t(v), causal=True, scale=0.2),
           want)


# ----------------------------------------------------------------------
# flash attention's routes, and the tensor-core route's rounding points
# ----------------------------------------------------------------------
@pytest.mark.parametrize("q_dtype,kv_dtype,dk,dv,want", [
    (torch.bfloat16, torch.bfloat16, 64, 64, "tc"),      # the serving path
    (torch.bfloat16, torch.bfloat16, 96, 64, "tc"),      # Dv != Dk
    (torch.bfloat16, torch.bfloat16, 256, 16, "tc"),
    (torch.bfloat16, torch.bfloat16, 72, 64, "simt"),    # not a 16 multiple
    (torch.bfloat16, torch.bfloat16, 64, 8, "simt"),
    (torch.float32, torch.float32, 64, 64, "simt"),      # float32 parity
    (torch.bfloat16, torch.float32, 64, 64, "simt"),     # mixed types
    (torch.float32, torch.bfloat16, 64, 64, "simt"),
])
def test_flash_route_by_dtype_and_head_dim(q_dtype, kv_dtype, dk, dv, want):
    assert flash_route(q_dtype, kv_dtype, dk, dv) == want


def test_flash_on_cpu_counts_no_route():
    q = torch.randn(1, 2, 8, 16, dtype=torch.bfloat16)
    counts = (flash_attention.launches, flash_attention.tc_launches,
              flash_attention.simt_launches)
    flash_attention(q, q, q)
    assert counts == (flash_attention.launches, flash_attention.tc_launches,
                      flash_attention.simt_launches)


TC_TILE = 64                          # keys per tile of the tensor-core route


def _tc_route_emulation(q, k, v, bias=None, causal=True, scale=None,
                        out_dtype=None):
    """The tensor-core route's arithmetic on the CPU, at its rounding
    points: logits in float32 from the bf16 operands, in log2 units, by
    64-key tiles; P = 2^(x - m) rounded to bf16 for the PV product; O and
    l (the sum of the rounded P) accumulated in float32; the tiles dealt
    to two key groups merged at the end when Sk <= 512, as the kernel
    does; the output rounded to bf16 (or to ``out_dtype``).  A row with
    no unmasked key gives 0."""
    f32 = torch.float32
    B, Hq, Sq, Dk = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kf = k.to(f32).repeat_interleave(rep, 1)
    vf = v.to(f32).repeat_interleave(rep, 1)
    scale = scale if scale is not None else 1.0 / np.sqrt(Dk)
    log2e = np.float32(1.4426950408889634)
    x = (q.to(f32) @ kf.transpose(-1, -2)) * (np.float32(scale) * log2e)
    if bias is not None:
        x = x + bias[:, None, None, :].to(f32) * log2e
    rows = torch.arange(Sq)[:, None] + (Sk - Sq)
    keys = torch.arange(Sk)[None, :]
    if causal:
        x = torch.where(keys <= rows, x, torch.tensor(-1e30))
    groups = 2 if Sk <= 8 * TC_TILE else 1
    n_tiles = -(-Sk // TC_TILE)
    states = []
    for grp in range(groups):
        m = torch.full((B, Hq, Sq), -1e30)
        l = torch.zeros(B, Hq, Sq)
        o = torch.zeros(B, Hq, Sq, v.shape[-1])
        for j in range(grp, n_tiles, groups):
            t = slice(j * TC_TILE, (j + 1) * TC_TILE)
            mn = torch.maximum(m, x[..., t].amax(-1))
            mu = torch.where(mn > -5e29, mn, torch.tensor(float("inf")))
            alpha = torch.exp2(m - mn)
            pb = torch.exp2(x[..., t] - mu[..., None]).to(
                torch.bfloat16).to(f32)
            l = l * alpha + pb.sum(-1)
            o = o * alpha[..., None] + pb @ vf[:, :, t]
            m = mn
        states.append((m, l, o))
    m, l, o = states[0]
    for m1, l1, o1 in states[1:]:
        mn = torch.maximum(m, m1)
        a0, a1 = torch.exp2(m - mn), torch.exp2(m1 - mn)
        l, o, m = l * a0 + l1 * a1, o * a0[..., None] + o1 * a1[..., None], mn
    return (o / l.clamp_min(1e-30)[..., None]).to(out_dtype or q.dtype)


@pytest.mark.parametrize("S", [100, 255, 2048])
def test_tc_route_rounding_holds_the_bf16_budget(S):
    """Rounding P to bf16 (the one rounding point the TPU kernel does not
    have) keeps the route within 8e-3 * max|plain| of the float32 oracle,
    the path's tolerance (chip_smoke.py).  Before the output's own bf16
    rounding (one step of which can take most of that budget on its own)
    the route is within a quarter of it."""
    rng = np.random.default_rng(S)
    B, Hq, Hkv, D = 1, 4, 2, 64

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q, k, v = bf(B, Hq, S, D), bf(B, Hkv, S, D), bf(B, Hkv, S, D)
    want = TR.flash_attention_ref(q, k, v, causal=True).float()
    got = _tc_route_emulation(q, k, v, causal=True).float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 8e-3 * scale
    f32 = [t.float() for t in (q, k, v)]
    want = TR.flash_attention_ref(*f32, causal=True)
    got = _tc_route_emulation(q, k, v, causal=True, out_dtype=torch.float32)
    assert float((got - want).abs().max()) <= 2e-3 * scale


def test_tc_route_emulation_masks_like_the_kernel():
    """Sq < Sk with Dk != Dv and a bias; rows whose keys are all masked
    (by the causal offset when Sq > Sk) give 0."""
    rng = np.random.default_rng(9)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q, k, v = bf(2, 4, 37, 96), bf(2, 2, 90, 96), bf(2, 2, 90, 64)
    bias = torch.from_numpy(_pad_bias(2, 90, [90, 70]))
    for causal in (True, False):
        want = TR.flash_attention_ref(q, k, v, bias=bias, causal=causal)
        got = _tc_route_emulation(q, k, v, bias=bias, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        assert err <= 8e-3 * float(want.float().abs().max())
    q = bf(1, 2, 40, 96)                      # Sq > Sk: rows 0-9 see none
    got = _tc_route_emulation(q, k[:1, :, :30], v[:1, :, :30], causal=True)
    assert float(got[:, :, :10].abs().max()) == 0.0
    want = TR.flash_attention_ref(q, k[:1, :, :30], v[:1, :, :30],
                                  causal=True)
    assert torch.isnan(want[:, :, :10]).all()     # the oracle's NaN
    err = float((got[:, :, 10:].float() - want[:, :, 10:].float()).abs().max())
    assert err <= 8e-3 * float(want[:, :, 10:].float().abs().max())


# ----------------------------------------------------------------------
# decode attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 4, 300, 64),                   # G = 1, ragged S
    (4, 8, 2, 512, 64),                   # G = 4
    (3, 4, 1, 256, 128),                  # MQA, D = 128
])
def test_decode_plain_matches_pallas_interpret(B, Hq, Hkv, S, D):
    _needs_jax()
    rng = np.random.default_rng(S + B)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    bias = _pad_bias(B, S, rng.integers(1, S, B))
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    bias=jnp.asarray(bias), interpret=True)
    got = decode_attention(_t(q), _t(k), _t(v), bias=_t(bias))
    _close(got, want)
    _close(got, JR.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        bias=jnp.asarray(bias)))


NEG_SKIP = -5e29                      # NEG_INF / 2: such keys are not read


def _merge(states):
    """Softmax states (m, l, acc) merged in order: the largest m, then
    each state's l and acc weighted by exp(m_i - m)."""
    m = states[0][0]
    for st in states[1:]:
        m = torch.maximum(m, st[0])
    w = [torch.exp(st[0] - m) for st in states]
    l = sum(st[1] * wi for st, wi in zip(states, w))
    acc = sum(st[2] * wi[..., None] for st, wi in zip(states, w))
    return m, l, acc


def _decode_split_emulation(q, k, v, bias=None, scale=None, n_sm=132):
    """The split kernel of ``csrc/decode_attention.cu`` on the CPU, in
    float32.  S is cut as :func:`DA.plan` cuts it; in a split the keys
    are dealt to the block's R row streams (R = 4 warps x 32 / LPR
    rows), NB keys a stream at a time; a key whose bias is at or below
    NEG_INF / 2 is never read (its K and V rows are replaced by zeros
    before use, so a NaN there must not show); each stream keeps an
    online softmax; the streams, then the splits in split order, are
    merged.  A row with no live key gives 0."""
    f32 = torch.float32
    B, Hq, Dk = q.shape
    Hkv, S, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(Dk)
    bias = (torch.zeros(B, S) if bias is None else bias).to(f32)
    per = 16 // k.element_size()
    lpr = next(n for n in (8, 16, 32) if n * per >= max(Dk, Dv))
    R = 4 * (32 // lpr)
    NB = 2 if G > 8 else 4 if (G > 4 or per == 8) else 8
    pl = DA.plan(B, Hkv, S, n_sm)
    qg = q.to(f32).reshape(B, Hkv, G, Dk)
    kf, vf = k.to(f32), v.to(f32)
    neg = torch.tensor(-1e30)
    splits = []
    for sp in range(pl.splits):
        begin = sp * pl.keys_per_split
        end = min(S, begin + pl.keys_per_split)
        streams = []
        for r in range(R):
            m = torch.full((B, Hkv, G), -1e30)
            l = torch.zeros(B, Hkv, G)
            acc = torch.zeros(B, Hkv, G, Dv)
            for k0 in range(begin, end, R * NB):
                idx = [k0 + i * R + r for i in range(NB)]
                idx = [j for j in idx if j < end]
                if not idx:
                    continue
                bv = bias[:, idx]                            # (B, nb)
                on = (bv > NEG_SKIP)[:, None, :, None]       # not read if off
                kk = torch.where(on, kf[:, :, idx], 0.0)
                vv = torch.where(on, vf[:, :, idx], 0.0)
                s = torch.einsum("bhgd,bhkd->bhgk", qg, kk) * scale
                s = torch.where(on[..., 0][:, :, None],
                                s + bv[:, None, None, :], -torch.inf)
                mx = torch.maximum(m, s.amax(-1))
                live = mx > NEG_SKIP
                alpha = torch.exp(m - mx)
                p = torch.where(live[..., None], torch.exp(s - mx[..., None]),
                                0.0)
                l = alpha * l + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgk,bhkd->bhgd", p, vv)
                m = mx
            streams.append((torch.maximum(m, neg), l, acc))
        splits.append(_merge(streams))
    m, l, acc = _merge(splits)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Dv).to(q.dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,n_sm", [
    (2, 4, 4, 300, 64, 132),              # G = 1, ragged S
    (4, 8, 2, 512, 64, 4),                # G = 4, 8 splits of 64
    (2, 16, 1, 200, 32, 132),             # G = 16, 7 splits, the last ragged
    (1, 4, 1, 2048, 128, 132),            # MQA, D = 128, 8 splits of 256
])
def test_decode_split_emulation_matches_pallas_interpret(B, Hq, Hkv, S, D,
                                                         n_sm):
    """Split S, merge in split order, skip masked keys: the kernel's
    algorithm against the Pallas kernel in interpret mode and the oracle,
    within 1e-5 * max|ref| + 1e-5 * |ref|.  The masked keys hold NaN, so
    a read of one would show."""
    _needs_jax()
    rng = np.random.default_rng(S + Hq)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lens = rng.integers(1, S, B)
    bias = _pad_bias(B, S, lens)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    bias=jnp.asarray(bias), interpret=True)
    dead = (bias <= NEG_SKIP)[:, None, :, None]
    kn, vn = np.where(dead, np.nan, k), np.where(dead, np.nan, v)
    got = _decode_split_emulation(_t(q), _t(kn), _t(vn), _t(bias),
                                  n_sm=n_sm)
    _close(got, want)
    _close(got, JR.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        bias=jnp.asarray(bias)))


def test_decode_split_emulation_masks_like_the_kernel():
    """A row whose keys are all masked gives 0, as the Pallas kernel does
    (the oracle gives the mean of the values); a bias of -1e4 is not
    skipped: a row whose keys all carry it is a plain softmax."""
    _needs_jax()
    rng = np.random.default_rng(5)
    B, Hq, Hkv, S, D = 3, 8, 2, 160, 64
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    bias = _pad_bias(B, S, [100, S, S])
    bias[1] = -1e30                          # no live key
    bias[2] = -1e4                           # all moderately negative
    want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bias=jnp.asarray(bias),
                               interpret=True))
    got = _decode_split_emulation(_t(q), _t(k), _t(v), _t(bias), n_sm=8)
    assert float(got[1].abs().max()) == 0.0 and not want[1].any()
    _close(got, want)
    plain = TR.decode_attention_ref(_t(q[2:]), _t(k[2:]), _t(v[2:]),
                                    bias=_t(bias[2:]))
    _close(got[2:], plain)                   # read, as the plain version
    assert float(got[2].abs().max()) > 0.1


def test_decode_split_emulation_holds_the_mixed_types():
    """The serving path's bfloat16 query against a float32 cache, and a
    bf16 cache (8 elements a 16-byte load), within the path's 8e-3."""
    rng = np.random.default_rng(8)
    B, Hq, Hkv, S, D = 4, 32, 8, 512, 64
    q = _t(rng.standard_normal((B, Hq, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
    bias = _t(_pad_bias(B, S, [18, 131, 302, 512]))
    for qt, kvt in ((torch.bfloat16, torch.float32),
                    (torch.bfloat16, torch.bfloat16),
                    (torch.float32, torch.bfloat16)):
        args = (q.to(qt), k.to(kvt), v.to(kvt), bias)
        got = _decode_split_emulation(*args).float()
        want = TR.decode_attention_ref(*args).float()
        assert float((got - want).abs().max()) <= 8e-3 * float(
            want.abs().max())


@pytest.mark.parametrize("B,Hkv,S,n_sm,want", [
    (4, 8, 512, 132, (64, 8, 256)),       # the serving shapes
    (4, 8, 2048, 132, (256, 8, 256)),
    (1, 8, 512, 132, (64, 8, 64)),        # too few heads for two waves
    (4, 8, 300, 132, (64, 5, 160)),       # ragged: the last split short
    (64, 8, 512, 132, (512, 1, 512)),     # many heads: one split each
    (2, 4, 9, 132, (32, 1, 8)),
    (1, 1, 100_000, 132, (12512, 8, 8)),
])
def test_decode_plan_fills_two_waves(B, Hkv, S, n_sm, want):
    pl = DA.plan(B, Hkv, S, n_sm)
    assert (pl.keys_per_split, pl.splits, pl.blocks) == want
    assert pl.splits * pl.keys_per_split >= S
    assert pl.splits <= DA.MAX_SPLITS and pl.keys_per_split % 32 == 0
    # two blocks an SM, unless shorter splits would not fit one cluster
    kps = pl.keys_per_split
    assert pl.blocks >= 2 * n_sm or kps == 32 or (
        -(-S // (kps - 32)) > DA.MAX_SPLITS)


# ----------------------------------------------------------------------
# fused MLP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T,d,f", [(4, 64, 128), (37, 128, 384),
                                   (130, 128, 256)])
def test_mlp_plain_matches_pallas_interpret_and_oracle(T, d, f):
    _needs_jax()
    rng = np.random.default_rng(T + f)
    x = rng.standard_normal((T, d)).astype(np.float32)
    wn = rng.standard_normal((d,)).astype(np.float32)
    wg = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    wu = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    wd = (rng.standard_normal((f, d)) * 0.05).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, wn, wg, wu, wd)]
    got = fused_mlp(*map(_t, (x, wn, wg, wu, wd)))
    _close(got, j_mlp(*args, block_t=64, block_f=128, interpret=True))
    _close(got, JR.fused_mlp_ref(*args))


def test_mlp_plain_keeps_the_norm_in_float32():
    """In bfloat16 the port (like the TPU kernel) does not round the
    normalized rows; ``repro.kernels.ref`` does.  Both agree in f32."""
    rng = np.random.default_rng(11)
    T, d, f = 8, 64, 128
    ws = [_t(rng.standard_normal(s).astype(np.float32) * c)
          for s, c in (((d,), 1.0), ((d, f), 0.1), ((d, f), 0.1),
                       ((f, d), 0.1))]
    x = _t(rng.standard_normal((T, d)).astype(np.float32))
    xb, wb = x.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws]
    kept = TR.fused_mlp_ref(xb, *wb)
    h = TR.rmsnorm_ref(xb, wb[0]).float()                 # rounded first
    rounded = ((torch.nn.functional.silu(h @ wb[1].float())
                * (h @ wb[2].float())) @ wb[3].float()).to(torch.bfloat16)
    assert kept.dtype == torch.bfloat16
    assert not torch.equal(kept, rounded)
    _close(kept.float(), rounded.float(), rtol=3e-2)


def test_mlp_plan_fills_one_wave_within_shared_memory():
    """The CUDA-core route's plan (float32, and bf16 shapes the other
    routes refuse), the tensor-core route's plan at granite's width, and
    the decode route's shared memory."""
    for T in (1, 4, 5, 17, 255, 512):
        p = plan(T, 2048, 8192, 132)
        rows, splits = -(-T // p.block_t), p.nsplit
        assert p.block_t >= min(T, 16) and smem_bytes(p.block_t, 2048) <= \
            SMEM_LIMIT
        assert rows * splits <= 132
        assert splits * p.steps_per_split * BLOCK_F >= 8192
        assert (splits - 1) * p.steps_per_split * BLOCK_F < 8192
    assert plan(4, 2048, 8192, 132) == MlpPlan(4, 128, 1)      # f32 decode
    assert plan(255, 2048, 8192, 132) == MlpPlan(16, 8, 16)   # f32 prefill
    with pytest.raises(ValueError, match="shared memory"):
        plan(4, 60000, 128, 132)
    for T in (9, 17, 64, 100, 128, 129, 255, 511, 2048):
        p = tc_plan(T, 8192, 132)
        rows = -(-T // (64 * p.mt))
        assert p.mt == (1 if T <= 128 else 2)
        assert p.fs % 64 == 0 and 64 <= p.fs <= 512
        assert tc_smem_bytes(p.mt, p.fs) <= SMEM_LIMIT
        assert p.nsplit * p.fs >= 8192 > (p.nsplit - 1) * p.fs
        widest = tc_smem_bytes(p.mt, p.fs + 64) > SMEM_LIMIT or p.fs == 512
        assert rows * p.nsplit <= 132 or widest    # one wave if it can
    assert tc_plan(17, 8192, 132) == TcPlan(1, 64, 128)
    assert tc_plan(100, 8192, 132) == TcPlan(1, 128, 64)
    assert tc_plan(255, 8192, 132) == TcPlan(2, 128, 64)
    assert tc_plan(2048, 8192, 132).fs == 448               # shared memory
    assert tc_plan(200, 200, 132) == TcPlan(2, 64, 4)       # ragged d_ff
    for tp in (1, 2, 4, 8):
        assert stream_smem_bytes(tp, 2048) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype,T,d,f,aligned,want", [
    (torch.bfloat16, 4, 2048, 8192, True, "stream"),     # granite decode
    (torch.bfloat16, 1, 2048, 8192, True, "stream"),
    (torch.bfloat16, STREAM_MAX_T, 2048, 8192, True, "stream"),
    (torch.bfloat16, STREAM_MAX_T + 1, 2048, 8192, True, "tc"),
    (torch.bfloat16, 17, 2048, 8192, True, "tc"),        # shortest prompt
    (torch.bfloat16, 255, 2048, 8192, True, "tc"),
    (torch.bfloat16, 4, 96, 200, True, "stream"),        # multiples of 8
    (torch.bfloat16, 40, 96, 200, True, "tc"),
    (torch.bfloat16, 4, 100, 200, True, "simt"),         # d % 8 != 0
    (torch.bfloat16, 40, 96, 204, True, "simt"),         # d_ff % 8 != 0
    (torch.bfloat16, 4, 2048, 8192, False, "simt"),      # misaligned
    (torch.bfloat16, 4, 60000, 128, True, "tc"),         # xn past smem
    (torch.float32, 4, 2048, 8192, True, "simt"),        # float32 parity
    (torch.float32, 255, 2048, 8192, True, "simt"),
])
def test_mlp_route_by_dtype_t_and_multiples_of_8(dtype, T, d, f, aligned,
                                                 want):
    assert mlp_route(dtype, T, d, f, aligned) == want


def test_mlp_on_cpu_counts_no_route():
    x = torch.randn(4, 16, dtype=torch.bfloat16)
    w = torch.randn(16, 24, dtype=torch.bfloat16)
    counts = (fused_mlp.launches, fused_mlp.stream_launches,
              fused_mlp.tc_launches, fused_mlp.simt_launches)
    fused_mlp(x, x[0], w, w, w.T.contiguous())
    assert counts == (fused_mlp.launches, fused_mlp.stream_launches,
                      fused_mlp.tc_launches, fused_mlp.simt_launches)


def _mlp_tc_emulation(x, w_norm, w_gate, w_up, w_down, eps=1e-6):
    """The tensor-core route's arithmetic on the CPU, at its rounding
    points: xn = x * rstd * w_norm in float32, rounded to bf16; g and u
    from the bf16 operands with float32 sums; a = silu(g) * u rounded to
    bf16; a @ Wd with float32 sums, returned in float32 (before the
    output's own rounding)."""
    f32, bf = torch.float32, torch.bfloat16
    xf = x.to(f32)
    rstd = 1.0 / torch.sqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xn = (xf * rstd * w_norm.to(f32)).to(bf).to(f32)
    g, u = xn @ w_gate.to(f32), xn @ w_up.to(f32)
    a = (torch.nn.functional.silu(g) * u).to(bf).to(f32)
    return a @ w_down.to(f32)


@pytest.mark.parametrize("T", [4, 255])
def test_mlp_tc_route_rounding_holds_the_bf16_budget(T):
    """Rounding xn and a to bf16 (the tensor-core route's two rounding
    points the float32 plain version does not have) keeps the route, at
    granite's width, within half of the path's 8e-3 * max|plain| budget
    before the output's own bf16 rounding, and within the budget after."""
    rng = np.random.default_rng(T)
    d, f = 2048, 8192

    def bf(shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32)).to(torch.bfloat16)
    x, wn = bf((T, d)), bf((d,))
    wg, wu, wd = bf((d, f), d ** -0.5), bf((d, f), d ** -0.5), \
        bf((f, d), f ** -0.5)
    want = TR.fused_mlp_ref(*(t.float() for t in (x, wn, wg, wu, wd)))
    got = _mlp_tc_emulation(x, wn, wg, wu, wd)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 4e-3 * scale
    rounded = got.to(torch.bfloat16).float()
    assert float((rounded - want).abs().max()) <= 8e-3 * scale


# ----------------------------------------------------------------------
# dispatch and wrappers on the CPU
# ----------------------------------------------------------------------
def test_ops_dispatch_on_cpu():
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((1, 4, 9, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
    counts = (flash_attention.launches, decode_attention.launches,
              fused_mlp.launches)
    for impl in ("auto", "ref"):
        assert torch.equal(ops.attention(q, k, k, impl=impl),
                           TR.flash_attention_ref(q, k, k))
        assert torch.equal(ops.decode_attention(q[:, :, 0], k, k, impl=impl),
                           TR.decode_attention_ref(q[:, :, 0], k, k))
    x = _t(rng.standard_normal((2, 3, 16)).astype(np.float32))
    w = _t(rng.standard_normal((16, 24)).astype(np.float32))
    y = ops.mlp(x, x[0, 0], w, w, w.T.contiguous())
    assert y.shape == x.shape
    assert torch.equal(y[1], TR.fused_mlp_ref(x[1], x[0, 0], w, w,
                                              w.T.contiguous()))
    assert counts == (flash_attention.launches, decode_attention.launches,
                      fused_mlp.launches)           # no kernel ran
    with pytest.raises(DeviceUnavailableError):
        ops.attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.mlp(x, x[0, 0], w, w, w.T, impl="triton")
    xs = x[..., None].expand(2, 3, 16, 4)       # ssd: (b, s, h, p)
    dt = torch.full((2, 3, 16), 0.1)
    A = -torch.ones(16)
    bc = x[:, :, None, :4]                      # (b, s, g=1, n=4)
    y, fs = ops.ssd(xs, dt, A, bc, bc, chunk=4)   # the plain version
    want = TR.ssd_ref(xs, dt, A, bc, bc, chunk=4)
    assert torch.equal(y, want[0]) and torch.equal(fs, want[1])


def test_wrappers_refuse_mixed_and_foreign_devices():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(q[:, :, 0].to("meta"), q.to("meta"), q.to("meta"))


def test_kernel_sources_export_their_launchers():
    for name, n_ptr in (("flash_attention", 5), ("decode_attention", 5),
                        ("fused_mlp", 7)):
        src = build.CudaSource(name).source
        assert f'extern "C" int {name}_launch(' in src
        assert f"LM_ERROR_STRING({name})" in src
        assert "src/repro/kernels/" in src          # names the TPU kernel
        heads = [h.name for h in build.included_headers(src)]
        # the bf16 routes share the tensor-core helpers
        assert heads == (["lm_common.cuh"] if name == "decode_attention"
                         else ["lm_common.cuh", "tensor_core.cuh"])
    src = build.CudaSource("fused_mlp").source
    for launcher in ("fused_mlp_stream_launch", "fused_mlp_tc_launch"):
        assert f'extern "C" int {launcher}(' in src


def test_library_digest_follows_only_included_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = '#include "b.cuh"\nint x;\n'
    assert [h.name for h in build.included_headers(src)] == ["b.cuh",
                                                              "a.cuh"]
    before = build.library_path("k", src)
    (tmp_path / "c.cuh").write_text("// c changed\n")
    assert build.library_path("k", src) == before      # not included
    (tmp_path / "a.cuh").write_text("// a changed\n")
    after = build.library_path("k", src)
    assert after != before and after.name.startswith("k_")
    with pytest.raises(ValueError):
        build.library_path("no good", src)


def test_missing_nvcc_names_the_kernels(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "CUDA_NVCC", build.BUILD_DIR / "no-nvcc")
    with pytest.raises(build.KernelBuildError,
                       match="nvcc not found.*decode_attention, fused_mlp"):
        build.find_nvcc(["fused_mlp", "decode_attention"])


# ----------------------------------------------------------------------
# on the card, at granite-3-2b's shapes
# ----------------------------------------------------------------------
def _card_close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [100, 128, 255])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(S, dtype):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    # the model's layout: (B, S, H, D) projections viewed head-major
    q = torch.randn(1, S, 32, 64, device="cuda", generator=gen).to(dtype)
    k = torch.randn(1, S, 8, 64, device="cuda", generator=gen).to(dtype)
    v = torch.randn(1, S, 8, 64, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (1, 32, S, 64)
    _card_close(out, TR.flash_attention_ref(q, k, v, causal=True), dtype)
    bias = torch.where(torch.arange(S, device="cuda") < S - 7, 0.0, -1e30)
    _card_close(flash_attention(q, k, v, bias=bias[None], causal=False),
                TR.flash_attention_ref(q, k, v, bias=bias[None],
                                       causal=False), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [
    (17, 130, 301, 511),                 # the served lengths
    (511, 511, 511, 511),                # every position live
    (0, 3, 40, 100),                     # most of the cache masked
])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_on_card(q_dtype, lens):
    """granite-3-2b's decode shapes against a float32 cache.  The keys
    the bias masks hold NaN: the kernel must not read them.  Two calls
    give the same bits; each counts one launch."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S = 4, 512
    q = torch.randn(B, 32, 64, device="cuda", generator=gen).to(q_dtype)
    k = torch.randn(B, 8, S, 64, device="cuda", generator=gen)
    v = torch.randn(B, 8, S, 64, device="cuda", generator=gen)
    keep = (torch.arange(S, device="cuda")[None]
            <= torch.tensor(lens, device="cuda")[:, None])
    bias = torch.where(keep, 0.0, -1e30)
    want = TR.decode_attention_ref(q, k, v, bias=bias)
    dead = ~keep[:, None, :, None]
    k, v = k.masked_fill(dead, float("nan")), v.masked_fill(dead, float("nan"))
    before = decode_attention.launches
    out = decode_attention(q, k, v, bias=bias)
    again = decode_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert out.dtype == q_dtype
    assert torch.equal(out, again)
    _card_close(out, want, q_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_masks_like_the_pallas_kernel_on_card(kv_dtype):
    """A row whose keys are all masked gives 0; a bias of -1e4 is read
    like any other; the split plan at S = 2048 (8 splits of 256) and at
    one KV head a sequence (G = 1: 8 splits of 64)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    for B, Hq, Hkv, S in ((3, 32, 8, 2048), (3, 1, 1, 512)):
        q = rand(B, Hq, 64).to(torch.bfloat16)
        k, v = rand(B, Hkv, S, 64).to(kv_dtype), rand(B, Hkv, S, 64).to(
            kv_dtype)
        bias = torch.zeros(B, S, device="cuda")
        bias[0, S // 3:] = -1e30
        bias[1] = -1e30                         # no live key
        bias[2] = -1e4
        out = decode_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        assert float(out[1].float().abs().max()) == 0.0
        want = TR.decode_attention_ref(q, k, v, bias=bias)
        _card_close(out[0::2], want[0::2], torch.bfloat16)


MLP_CARD_T = (1, 4, 16, 17, 64, 255)   # decode, the split, served prompts


def _granite_mlp(T, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, f = 2048, 8192

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * std).to(dtype)
    return (rand(T, d), rand(d), rand(d, f, std=d ** -0.5),
            rand(d, f, std=d ** -0.5), rand(f, d, std=f ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("T", MLP_CARD_T)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_kernel_matches_plain_on_card(T, dtype):
    """The route the wrapper picks, counted once in its own count."""
    _needs_card()
    args = _granite_mlp(T, dtype, T)
    which = mlp_route(dtype, T, 2048, 8192)
    before = (fused_mlp.launches, getattr(fused_mlp, f"{which}_launches"))
    out = fused_mlp(*args)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, getattr(fused_mlp, f"{which}_launches")) \
        == (before[0] + 1, before[1] + 1)
    _card_close(out, TR.fused_mlp_ref(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", MLP_CARD_T)
@pytest.mark.parametrize("which", ["stream", "tc", "simt"])
def test_mlp_each_route_matches_plain_on_card(T, which):
    """Every bf16 route at granite's width, whichever T the split gives
    it (the decode route takes T <= STREAM_MAX_T only)."""
    _needs_card()
    if which == "stream" and T > STREAM_MAX_T:
        pytest.skip("the decode route takes T <= STREAM_MAX_T")
    from repro_torch.kernels.fused_mlp import launch_route
    args = _granite_mlp(T, torch.bfloat16, 100 + T)
    out = launch_route(which, *args, 1e-6)
    torch.cuda.synchronize()
    _card_close(out, TR.fused_mlp_ref(*args), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_ragged_and_general_shapes_on_card(dtype):
    """Off the serving path: Sq < Sk with Dv != Dk and a bias; decode with
    G = 1 and 8 at D = 128 without a bias; the MLP with d and d_ff that
    are not multiples of 64 and several row tiles."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * std).to(dtype)
    q, k, v = rand(2, 4, 37, 64), rand(2, 2, 90, 64), rand(2, 2, 90, 32)
    bias = torch.where(torch.rand(2, 90, device="cuda", generator=gen)
                       < 0.8, 0.0, -1e30)
    bias[:, -1] = 0.0       # a key for every row; causal rows see >= 54
    for causal in (True, False):
        _card_close(flash_attention(q, k, v, bias=bias, causal=causal,
                                    scale=0.2),
                    TR.flash_attention_ref(q, k, v, bias=bias,
                                           causal=causal, scale=0.2), dtype)
    for Hq, Hkv in ((8, 8), (16, 2)):
        q, k, v = rand(3, Hq, 128), rand(3, Hkv, 300, 128), \
            rand(3, Hkv, 300, 128)
        _card_close(decode_attention(q, k, v), TR.decode_attention_ref(
            q, k, v), dtype)
    for T in (5, 40):     # bf16: the decode and the tensor-core route
        d, f = 96, 200
        x, wn = rand(T, d), rand(d)
        wg, wu, wd = rand(d, f, std=d ** -0.5), rand(d, f, std=d ** -0.5), \
            rand(f, d, std=f ** -0.5)
        _card_close(fused_mlp(x, wn, wg, wu, wd),
                    TR.fused_mlp_ref(x, wn, wg, wu, wd), dtype)
        # d not a multiple of 8, and a misaligned x: the CUDA-core route
        before = fused_mlp.simt_launches
        _card_close(fused_mlp(x[:, :92].contiguous(), wn[:92], wg[:92],
                              wu[:92], wd[:, :92].contiguous()),
                    TR.fused_mlp_ref(x[:, :92], wn[:92], wg[:92], wu[:92],
                                     wd[:, :92]), dtype)
        flat = rand(T * d + 1)
        xm = flat[1:].view(T, d)
        _card_close(fused_mlp(xm, wn, wg, wu, wd),
                    TR.fused_mlp_ref(xm, wn, wg, wu, wd), dtype)
        assert fused_mlp.simt_launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 17, 100, 128, 200, 255, 300, 511, 2048])
def test_flash_tc_route_matches_plain_on_card(S):
    """granite-3-2b's prefill shapes (32/8 heads of 64, the model's
    head-major views), one and two key groups, on the tensor cores."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    q, k, v = (torch.randn(1, S, h, 64, device="cuda", generator=gen)
               .to(torch.bfloat16).transpose(1, 2) for h in (32, 8, 8))
    before = (flash_attention.tc_launches, flash_attention.simt_launches)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (flash_attention.tc_launches,
            flash_attention.simt_launches) == (before[0] + 1, before[1])
    _card_close(out, TR.flash_attention_ref(q, k, v, causal=True),
                torch.bfloat16)


@pytest.mark.gpu
def test_flash_tc_route_general_shapes_on_card():
    """Sq < Sk with Dk = 96, Dv = 64 and a bias, causal or not; rows whose
    keys are all masked (by the causal offset when Sq > Sk, or by the
    bias) give 0."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
    q, k, v = rand(2, 4, 37, 96), rand(2, 2, 90, 96), rand(2, 2, 90, 64)
    bias = torch.where(torch.rand(2, 90, device="cuda", generator=gen)
                       < 0.8, 0.0, -1e30)
    bias[:, -1] = 0.0
    before = flash_attention.tc_launches
    for causal in (True, False):
        _card_close(flash_attention(q, k, v, bias=bias, causal=causal),
                    TR.flash_attention_ref(q, k, v, bias=bias, causal=causal),
                    torch.bfloat16)
    # two key groups with every tile in flight, two with the ring
    # refilled, one key group
    for Sk in (90, 300, 600):
        k2, v2 = rand(2, 2, Sk, 96), rand(2, 2, Sk, 64)
        q2 = rand(2, 4, Sk + 10, 96)         # rows 0-9 see no key
        out = flash_attention(q2, k2, v2, causal=True)
        want = TR.flash_attention_ref(q2, k2, v2, causal=True)
        torch.cuda.synchronize()
        assert float(out[:, :, :10].abs().max()) == 0.0
        _card_close(out[:, :, 10:], want[:, :, 10:], torch.bfloat16)
        dead = torch.zeros(2, Sk, device="cuda")
        dead[1] = -1e30                      # batch 1 sees no key
        out = flash_attention(k2.repeat(1, 2, 1, 1), k2, v2, bias=dead,
                              causal=False)
        torch.cuda.synchronize()
        assert float(out[1].abs().max()) == 0.0
        _card_close(out[:1], TR.flash_attention_ref(
            k2.repeat(1, 2, 1, 1)[:1], k2[:1], v2[:1], causal=False),
            torch.bfloat16)
    assert flash_attention.tc_launches == before + 8
