"""The Mamba2 SSD scan of the port: its plain versions against the JAX
package, and the Hopper kernel against its plain version.

On the CPU ``ops.ssd`` and the kernel's wrapper run the plain version
(``repro_torch.kernels.ref.ssd_ref``, ``ssd_scan_ref`` after dt = 0
padding).  They are held against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and against ``repro.kernels.ref``, at
the shapes of ``tests/test_kernels.py``, in float32, within
1e-5 * max|ref| + 1e-5 * |ref|.  The chunked scan is also held against
the token-by-token recurrence within 5e-4, the reference's own property
test's tolerance (the two sum in different orders over up to 96 steps).

Tests marked ``gpu`` build the kernel with nvcc and hold it against its
plain version on the card at mamba2-2.7b's and zamba2-1.2b's shapes:
float32 within 1e-5 * max|plain|, bfloat16 within 8e-3 * max|plain|
(two bfloat16 steps).  They skip without a card; the JAX parity tests
skip where JAX is missing.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as SK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax.numpy as jnp
    from repro.kernels import ops as JO
    from repro.kernels import ref as JR
    from repro.kernels.ssd_scan import ssd_scan as j_ssd
except ImportError:
    jnp = None

RTOL = 1e-5                          # relative to max|ref| and to |ref|
SEQ_TOL = 5e-4                       # chunked vs sequential (abs)


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


def _inputs(rng, b, s, h, p, g, n, init=False):
    """x, dt, A, B, C (and init_state) as the reference's tests draw them."""
    arrays = [rng.normal(size=(b, s, h, p)).astype(np.float32),
              rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
              (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32),
              rng.normal(size=(b, s, g, n)).astype(np.float32),
              rng.normal(size=(b, s, g, n)).astype(np.float32)]
    if init:
        arrays.append(rng.normal(size=(b, h, p, n)).astype(np.float32))
    return arrays


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ----------------------------------------------------------------------
# the plain versions against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 128, 4, 16, 2, 32, 32), (1, 256, 8, 64, 1, 128, 64),
    (2, 96, 4, 16, 4, 32, 32)])
def test_ssd_matches_pallas_interpret_and_oracle(b, s, h, p, g, n, chunk):
    _needs_jax()
    arrays = _inputs(np.random.default_rng(s + h), b, s, h, p, g, n)
    y, fs = ops.ssd(*_t(arrays), chunk=chunk)
    yk, fk = j_ssd(*_j(arrays), chunk=chunk, interpret=True)
    _close(y, yk)
    _close(fs, fk)
    yr, fr = JR.ssd_scan_ref(*_j(arrays), chunk=chunk)
    _close(TR.ssd_scan_ref(*_t(arrays), chunk=chunk)[0], yr)
    _close(y, yr)
    _close(fs, fr)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 100, 4, 16, 2, 32, 32),      # g > 1, ragged last chunk
    (1, 17, 8, 16, 1, 16, 16),       # one full chunk and one row
    (2, 21, 6, 8, 3, 16, 64)])       # shorter than one chunk
def test_ragged_ssd_matches_the_padded_pallas_route(b, s, h, p, g, n, chunk):
    """Both packages pad a ragged sequence with dt = 0 steps; y is
    cropped back to s rows."""
    _needs_jax()
    arrays = _inputs(np.random.default_rng(s * g), b, s, h, p, g, n)
    y, fs = ops.ssd(*_t(arrays), chunk=chunk)
    assert tuple(y.shape) == (b, s, h, p)
    yk, fk = JO.ssd(*_j(arrays), chunk=chunk, impl="pallas")
    _close(y, yk)
    _close(fs, fk)
    yr, fr = JO.ssd(*_j(arrays), chunk=chunk, impl="ref")
    _close(y, yr)
    _close(fs, fr)


@pytest.mark.parametrize("s", [64, 70])
def test_init_state_matches_the_oracle(s):
    """The reference's Pallas route refuses ``init_state``; its oracle
    takes it, and so do both of the port's routes."""
    _needs_jax()
    b, h, p, g, n, chunk = 2, 4, 16, 2, 32, 32
    arrays = _inputs(np.random.default_rng(s), b, s, h, p, g, n, init=True)
    x, dt, A, B, C, i0 = _t(arrays)
    y, fs = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=i0)
    yr, fr = JO.ssd(*_j(arrays[:5]), chunk=chunk, impl="ref",
                    init_state=jnp.asarray(arrays[5]))
    _close(y, yr)
    _close(fs, fr)
    ys, fss = JR.ssd_sequential_ref(*_j(arrays[:5]),
                                    init_state=jnp.asarray(arrays[5]))
    got = TR.ssd_sequential_ref(x, dt, A, B, C, init_state=i0)
    _close(got[0], ys)
    _close(got[1], fss)
    with pytest.raises(NotImplementedError):
        JO.ssd(*_j(arrays[:5]), chunk=chunk, impl="pallas",
               init_state=jnp.asarray(arrays[5]))


@given(st.integers(8, 96), st.integers(2, 12), st.booleans(),
       st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_chunked_scan_equals_sequential(s, h, init, seed):
    """Property: the chunked scan (any length, any start state) equals
    the token-by-token recurrence."""
    rng = np.random.default_rng(seed)
    arrays = _t(_inputs(rng, 1, s, h, 8, 1, 16, init=init))
    i0 = arrays[5] if init else None
    y1, f1 = ops.ssd(*arrays[:5], chunk=16, init_state=i0)
    y2, f2 = TR.ssd_sequential_ref(*arrays[:5], init_state=i0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=SEQ_TOL)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), atol=SEQ_TOL)


# ----------------------------------------------------------------------
# the kernel's three passes, emulated on the CPU
# ----------------------------------------------------------------------
def _tf32(t):
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, split):
    """``einsum(eq, a, b)`` in float32; with ``split`` as the kernel's
    tensor cores take it, 3xTF32: a = ah + al, b = bh + bl with each part
    TF32, al bh + ah bl + ah bh (al bl dropped); with ``split`` = 1, the
    plain TF32 product ah bh."""
    if not split:
        return torch.einsum(eq, a, b)
    ah, bh = _tf32(a), _tf32(b)
    if split == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _scan_passes_emulation(x, dt, A, B, C, chunk, init_state=None,
                           split=3):
    """The chunk-parallel passes of ``csrc/ssd_scan.cu`` on the CPU, in
    float32, every product in 3xTF32 as the kernel's tensor cores take it
    (``split`` = 0: plain float32 products).  Chunk pass: each chunk's cumsum of dt A (rows past s add
    0), its own end state S_c = ((x dt) ⊙ exp(cs_last - cs))^T B, and
    C B^T once per (batch, group, chunk), stored transposed.  State pass:
    state_c = state_{c-1} exp(cs_last_c) + S_c, sequential over chunks
    only, keeping each chunk's incoming state.  Output pass: y = (C B^T ⊙
    exp(cs_i - cs_j), j <= i) (x dt) + exp(cs) ⊙ (C state_{c-1}^T),
    rounded to x's type once."""
    f32 = torch.float32
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L, rep = chunk, h // g
    nc = -(-s // L)
    pad = nc * L - s

    def rows(t):                                # zero rows past s
        t = t.to(f32)
        return torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], 1)
    xc = rows(x).reshape(b, nc, L, h, p)
    dtc = rows(dt).reshape(b, nc, L, h)
    Bc = rows(B).reshape(b, nc, L, g, n)
    Cc = rows(C).reshape(b, nc, L, g, n)
    heads = torch.arange(h) // rep              # head -> its group

    # 1. chunk pass
    cs = torch.cumsum(dtc * A.to(f32), dim=2)               # (b,c,l,h)
    last = cs[:, :, -1]                                      # (b,c,h)
    cbt = _product("bcjgn,bcign->bcgji", Bc, Cc, split)     # per group
    xd = xc * dtc[..., None]
    xdd = xd * torch.exp(last[:, :, None] - cs)[..., None]
    own = _product("bclhp,bclhn->bchpn", xdd, Bc[:, :, :, heads], split)
    # 2. state pass
    state = (torch.zeros((b, h, p, n), dtype=f32) if init_state is None
             else init_state.to(f32))
    incoming = []
    for c in range(nc):
        incoming.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + own[:, c]
    prev = torch.stack(incoming, 1)                          # (b,c,h,p,n)
    # 3. output pass
    lower = torch.arange(L)[:, None] >= torch.arange(L)[None, :]  # i >= j
    diff = cs.movedim(-1, 2)[..., :, None] - cs.movedim(-1, 2)[..., None, :]
    dec = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0)
    m = cbt[:, :, heads].transpose(-1, -2) * dec             # (b,c,h,i,j)
    y_off = _product("bcihn,bchpn->bcihp", Cc[:, :, :, heads], prev, split)
    y = y_off * torch.exp(cs)[..., None] + _product(
        "bchij,bcjhp->bcihp", m, xd, split)
    return y.reshape(b, nc * L, h, p)[:, :s].to(x.dtype), state


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", [
    (1, 128, 4, 16, 1, 32, 128, False),   # one chunk
    (2, 256, 4, 16, 2, 32, 16, False),    # 16 chunks, g > 1
    (1, 100, 6, 8, 3, 16, 32, False),     # ragged last chunk, g = 3
    (2, 70, 4, 16, 2, 32, 32, True),      # init_state, ragged
    (1, 255, 8, 64, 1, 128, 128, True),   # mamba2's widths, 2 chunks
])
def test_scan_passes_match_the_jax_scan(b, s, h, p, g, n, chunk, init):
    """The three passes against the reference: its Pallas kernel in
    interpret mode where it runs (whole chunks, no start state), its
    padded Pallas route for a ragged length, its oracle for a start
    state; within 1e-5 * max|ref| + 1e-5 * |ref|."""
    _needs_jax()
    arrays = _inputs(np.random.default_rng(s + h + g), b, s, h, p, g, n,
                     init=init)
    got = _scan_passes_emulation(*_t(arrays[:5]), chunk,
                                 _t(arrays[5:])[0] if init else None)
    if init:
        want = JO.ssd(*_j(arrays[:5]), chunk=chunk, impl="ref",
                      init_state=jnp.asarray(arrays[5]))
    elif s % chunk:
        want = JO.ssd(*_j(arrays), chunk=chunk, impl="pallas")
    else:
        want = j_ssd(*_j(arrays), chunk=chunk, interpret=True)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # and the plain version the card holds the kernel against
    plain = TR.ssd_ref(*_t(arrays[:5]), chunk=chunk,
                       init_state=_t(arrays[5:])[0] if init else None)
    _close(got[0], plain[0])
    _close(got[1], plain[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_3xtf32_products_hold_the_float32_budget(dtype):
    """The kernel's products on the tensor cores in 3xTF32 keep y and the
    final state within 1e-5 * max|plain| of the float32 plain version of
    the same inputs, at mamba2-2.7b's widths over two chunks and a start
    state; the plain TF32 product (one rounding of each float32 operand)
    would not."""
    rng = np.random.default_rng(12)
    x, dt, A, B, C, i0 = _t(_inputs(rng, 1, 255, 4, 64, 1, 128, init=True))
    x, B, C = (t.to(dtype) for t in (x, B, C))
    yr, fr = TR.ssd_ref(x.float(), dt, A, B.float(), C.float(), chunk=128,
                        init_state=i0)
    errs = {}
    for split in (3, 1):
        y, fs = _scan_passes_emulation(x.float(), dt, A, B.float(),
                                       C.float(), 128, i0, split=split)
        errs[split] = (float((y - yr).abs().max() / yr.abs().max()),
                       float((fs - fr).abs().max() / fr.abs().max()))
    assert max(errs[3]) <= 1e-5, errs
    assert max(errs[1]) > 1e-5, errs


def test_scan_passes_keep_bf16_inputs_exact_until_y():
    """bf16 x, B and C: every product runs on their exact float32 values,
    so the final state matches the float32 plain version of the same
    inputs within 1e-5 and only y rounds (to bf16, once)."""
    rng = np.random.default_rng(11)
    arrays = _t(_inputs(rng, 1, 200, 4, 16, 1, 32, init=True))
    x, dt, A, B, C, i0 = arrays
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    y, fs = _scan_passes_emulation(xb, dt, A, Bb, Cb, 64, i0)
    yr, fr = TR.ssd_ref(xb.float(), dt, A, Bb.float(), Cb.float(), chunk=64,
                        init_state=i0)
    assert y.dtype == torch.bfloat16
    _close(fs, fr)
    assert float((y.float() - yr).abs().max()) <= 8e-3 * float(
        yr.abs().max())


def test_scan_plan_counts_blocks_and_scratch():
    """The launch plan at the served shapes, without nvcc: two chunks of
    mamba2's prefill of 255 give 326 chunk-pass blocks (6 C B^T tiles and
    80 heads x 2 chunks x 2 P tiles), 640 state-pass blocks (one float4
    of the 64 x 128 state a thread) and 320 output-pass blocks; two
    blocks fit an SM in every pass; at s = 2048 the chunk states take
    16 x 80 x 64 x 128 floats."""
    pl = SK.plan(1, 255, 80, 64, 1, 128, 128)
    assert (pl.chunks, pl.p_tiles, pl.cb_blocks) == (2, 2, 6)
    assert (pl.chunk_blocks, pl.state_blocks, pl.output_blocks) == (
        326, 640, 320)
    assert pl.smem == (91136, 0, 90624)
    assert 2 * max(pl.smem) <= SK.SMEM_LIMIT
    pl = SK.plan(1, 2048, 80, 64, 1, 128, 128)
    assert pl.chunks == 16 and pl.output_blocks == 2560
    assert pl.scratch_floats == 16 * 128 * 128 + 16 * 80 * 64 * 128 + 16 * 80
    assert 4 * pl.scratch_floats < 44e6
    pl = SK.plan(2, 37, 6, 40, 3, 16, 16)     # small chunks, ragged P
    assert (pl.chunks, pl.p_tiles, pl.cb_blocks) == (3, 2, 18)
    assert pl.state_blocks == 12 and pl.output_blocks == 2 * 6 * 3 * 2
    assert SK.smem_bytes(128, 128) == max(SK.plan(1, 1, 1, 1, 1, 128,
                                                  128).smem)


# ----------------------------------------------------------------------
# the wrapper on the CPU
# ----------------------------------------------------------------------
def test_ops_ssd_and_the_wrapper_run_the_plain_version_on_cpu():
    arrays = _t(_inputs(np.random.default_rng(5), 1, 40, 4, 8, 2, 16,
                        init=True))
    before = ssd_scan.launches
    want = TR.ssd_ref(*arrays[:5], chunk=16, init_state=arrays[5])
    for got in (ssd_scan(*arrays[:5], chunk=16, init_state=arrays[5]),
                ops.ssd(*arrays[:5], chunk=16, init_state=arrays[5]),
                ops.ssd(*arrays[:5], chunk=16, impl="ref",
                        init_state=arrays[5])):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ssd_scan.launches == before              # no kernel ran
    with pytest.raises(ValueError, match="one device"):
        ssd_scan(arrays[0], arrays[1].to("meta"), *arrays[2:5])


def test_the_launch_path_refuses_what_the_kernel_cannot_take():
    """The checks before a launch, run on CPU tensors (they raise before
    the library is built)."""
    x, dt, A, B, C = _t(_inputs(np.random.default_rng(6), 1, 8, 4, 8, 2,
                                16))
    bad = [
        ((x[0], dt, A, B, C, 16, None), "must be"),
        ((x, dt[:, :4], A, B, C, 16, None), "do not fit"),
        ((x, dt, A, B[:, :, :1].expand(1, 8, 3, 16), C, 16, None),
         "do not fit"),
        ((x, dt, A, B, C, 256, None), "chunk 256"),
        ((x, dt, A, B[..., :6], C[..., :6], 16, None), "n 6"),
        ((x, dt.double(), A, B, C, 16, None), "float32"),
        ((x, dt, A, B.to(torch.bfloat16), C, 16, None), "share a type"),
        ((x, dt, A, B, C.transpose(2, 3).contiguous().transpose(2, 3), 16,
          None), "contiguous"),
        ((x, dt, A, B, C, 16, torch.zeros(1, 4, 8, 8)), "init_state"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            SK._launch(*args)
    assert SK.smem_bytes(128, 352) <= SK.SMEM_LIMIT < SK.smem_bytes(128, 356)
    with pytest.raises(ValueError, match="shared memory"):
        SK._launch(x, dt, A, *(torch.zeros(1, 8, 2, 356),) * 2, 128, None)


def test_kernel_source_exports_its_launcher():
    src = build.CudaSource("ssd_scan").source
    assert 'extern "C" int ssd_scan_launch(' in src
    assert "LM_ERROR_STRING(ssd_scan)" in src
    assert "src/repro/kernels/ssd_scan.py" in src    # names the TPU kernel
    assert [h.name for h in build.included_headers(src)] == ["lm_common.cuh"]
    assert f"kPS = {SK.BLOCK_P};" in src and f"kLMax = {SK.MAX_CHUNK};" in src


# ----------------------------------------------------------------------
# on the card, at the serving path's shapes
# ----------------------------------------------------------------------
def _card_inputs(b, s, h, p, g, n, dtype, init, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    x = randn(b, s, h, p).to(dtype)
    dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device="cuda", generator=gen) * 1.5 + 0.5)
    B, C = randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)
    return x, dt, A, B, C, randn(b, h, p, n) if init else None


def _card_close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n,init", [
    (1, 255, 80, 64, 1, 128, False),     # mamba2-2.7b, ragged
    (1, 256, 80, 64, 1, 128, True),      # mamba2-2.7b, two chunks
    (1, 128, 80, 64, 1, 128, False),     # one chunk
    (1, 2048, 80, 64, 1, 128, False),    # 16 chunks of carried state
    (1, 200, 64, 64, 1, 64, False),      # zamba2-1.2b
    (2, 300, 8, 64, 2, 128, True),       # g > 1, b > 1
    (1, 37, 6, 40, 3, 16, True),         # P not a multiple of 32
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_on_card(b, s, h, p, g, n, init, dtype):
    """y within 1e-5 (float32) or 8e-3 (bf16) and the final state within
    1e-5 in both; two calls give the same bits; one launch counted a
    call, whatever the passes."""
    _needs_card()
    x, dt, A, B, C, i0 = _card_inputs(b, s, h, p, g, n, dtype, init, s)
    before = ssd_scan.launches
    y, fs = ssd_scan(x, dt, A, B, C, chunk=128, init_state=i0)
    y2, fs2 = ssd_scan(x, dt, A, B, C, chunk=128, init_state=i0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(fs, fs2)
    assert y.dtype == dtype and tuple(y.shape) == (b, s, h, p)
    assert fs.dtype == torch.float32 and tuple(fs.shape) == (b, h, p, n)
    yr, fr = TR.ssd_ref(x, dt, A, B, C, chunk=128, init_state=i0)
    _card_close(y, yr, dtype)
    _card_close(fs, fr, torch.float32)     # float32 from the same inputs


@pytest.mark.gpu
def test_ssd_kernel_takes_strided_views_and_small_chunks_on_card():
    """The model's views (x, B, C slices of one projection) and the smoke
    configs' chunk of 16."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, p, n = 2, 45, 8, 16, 16
    xbc = torch.randn(b, s, h * p + 2 * n, device="cuda", generator=gen)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, s, 1, n)
    C = xbc[..., h * p + n:].reshape(b, s, 1, n)
    dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.2
    A = -torch.rand(h, device="cuda", generator=gen) - 0.5
    y, fs = ssd_scan(x, dt, A, B, C, chunk=16)
    yr, fr = TR.ssd_ref(x, dt, A, B, C, chunk=16)
    _card_close(y, yr, torch.float32)
    _card_close(fs, fr, torch.float32)
