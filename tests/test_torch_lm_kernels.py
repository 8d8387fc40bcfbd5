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
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.fused_mlp import (BLOCK_F, SMEM_LIMIT,  # noqa: E402
                                           MlpPlan, fused_mlp, plan,
                                           smem_bytes)

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
    for T in (1, 4, 5, 17, 255, 512):
        p = plan(T, 2048, 8192, 132)
        rows, splits = -(-T // p.block_t), p.nsplit
        assert p.block_t >= min(T, 16) and smem_bytes(p.block_t, 2048) <= \
            SMEM_LIMIT
        assert rows * splits <= 132
        assert splits * p.steps_per_split * BLOCK_F >= 8192
        assert (splits - 1) * p.steps_per_split * BLOCK_F < 8192
    assert plan(4, 2048, 8192, 132) == MlpPlan(4, 128, 1)      # decode
    assert plan(255, 2048, 8192, 132) == MlpPlan(16, 8, 16)   # prefill
    with pytest.raises(ValueError, match="shared memory"):
        plan(4, 60000, 128, 132)


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
        assert heads == ["lm_common.cuh"]


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
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_on_card(q_dtype):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S = 4, 512
    q = torch.randn(B, 32, 64, device="cuda", generator=gen).to(q_dtype)
    k = torch.randn(B, 8, S, 64, device="cuda", generator=gen)
    v = torch.randn(B, 8, S, 64, device="cuda", generator=gen)
    lens = torch.tensor([17, 130, 301, 511], device="cuda")
    keep = torch.arange(S, device="cuda")[None] <= lens[:, None]
    bias = torch.where(keep, 0.0, -1e30)
    before = decode_attention.launches
    out = decode_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == q_dtype
    _card_close(out, TR.decode_attention_ref(q, k, v, bias=bias), q_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 255])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_kernel_matches_plain_on_card(T, dtype):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(T)
    d, f = 2048, 8192

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * std).to(dtype)
    x, wn = rand(T, d), rand(d)
    wg, wu, wd = rand(d, f, std=d ** -0.5), rand(d, f, std=d ** -0.5), \
        rand(f, d, std=f ** -0.5)
    before = fused_mlp.launches
    out = fused_mlp(x, wn, wg, wu, wd)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    _card_close(out, TR.fused_mlp_ref(x, wn, wg, wu, wd), dtype)


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
    for T in (5, 40):
        d, f = 96, 200
        x, wn = rand(T, d), rand(d)
        wg, wu, wd = rand(d, f, std=d ** -0.5), rand(d, f, std=d ** -0.5), \
            rand(f, d, std=f ** -0.5)
        _card_close(fused_mlp(x, wn, wg, wu, wd),
                    TR.fused_mlp_ref(x, wn, wg, wu, wd), dtype)
