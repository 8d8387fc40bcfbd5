"""The fused pointwise stage chain of the port against the JAX package,
and the Hopper kernel against its plain version.

On the CPU, ``stream_pipeline`` and ``stream_pipeline_staged`` run the
plain version (after recording the chain); both are held against
``repro.kernels.stream_pipeline`` (the Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it, and its staged baseline) within
1e-5 * max|ref| + 1e-5 * |ref|.  The recorded chain, evaluated with
torch, equals the plain chain bit for bit; the CUDA source generates
without nvcc; what the kernel does not take raises a typed error.

Tests marked ``gpu`` build the kernel with nvcc and hold it against the
plain version on the card within 1e-6 * max|plain| (0 expected with
``-fmad=false``); they skip without a card.  The JAX parity tests skip
where JAX is missing.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.backends import UnsupportedBackendError  # noqa: E402
from repro_torch.device import NotPortedError  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.expr import evaluate  # noqa: E402
from repro_torch.kernels.stream_pipeline import (  # noqa: E402
    HEAVY_COST, PipelineKernel, stream_pipeline, stream_pipeline_ref,
    stream_pipeline_staged, unroll)

try:                                 # the card's machine has no JAX
    import jax.numpy as jnp
    from repro.kernels.stream_pipeline import stream_pipeline as j_fused
    from repro.kernels.stream_pipeline import \
        stream_pipeline_staged as j_staged
except ImportError:
    jnp = None

RTOL = 1e-5                          # relative to max|ref| and to |ref|
CARD_TOL = 1e-6                      # kernel vs plain, relative to max|plain|


def _c4(tanh, abs_, sqrt):
    """The JAX test's chain (``tests/test_kernels.py``), in one framework."""
    return (tanh, lambda v: v * 2.0, abs_, sqrt)


# chain name -> (torch fns, whether the input is made non-negative)
CHAINS = {
    "c4": (_c4(torch.tanh, torch.abs, torch.sqrt), True),
    "bool_mid": ((lambda v: v > 0.5, lambda v: v * 2.0), False),
}
# (H, W, tile of the JAX call)
SHAPES = [(100, 300, (32, 128)), (1, 1, (256, 512)), (8, 128, (256, 512)),
          (257, 513, (256, 512))]


def _jax_fns(name):
    if name == "c4":
        return _c4(jnp.tanh, jnp.abs, jnp.sqrt)
    return CHAINS[name][0]           # operators only: the same lambdas


def _input(name, H, W, seed=0):
    x = np.random.default_rng(seed).normal(size=(H, W)).astype(np.float32)
    return np.abs(x) if CHAINS[name][1] else x


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


def _card_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    err = float((got - want).abs()[~nan].max())
    assert err <= CARD_TOL * float(want.abs()[~nan].max())


# ----------------------------------------------------------------------
# parity with the JAX package (CPU)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("H,W,tile", SHAPES)
def test_matches_jax_fused_and_staged(name, H, W, tile):
    _needs_jax()
    x = _input(name, H, W)
    fns = CHAINS[name][0]
    jfns = _jax_fns(name)
    want = np.asarray(j_fused(jnp.asarray(x), jfns, tile=tile,
                              interpret=True))
    want_staged = np.asarray(j_staged(jnp.asarray(x), jfns))
    got = stream_pipeline(torch.from_numpy(x), fns, tile=tile)
    got_staged = stream_pipeline_staged(torch.from_numpy(x), fns)
    assert got.dtype == torch.float32 and got_staged.dtype == torch.float32
    _close(got.numpy(), want)
    _close(got_staged.numpy(), want_staged.astype(np.float32))


# ----------------------------------------------------------------------
# the recorder and the generated source (CPU)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CHAINS) + ["c16"])
def test_recorded_chain_equals_plain_chain(name):
    fns = CHAINS["c4"][0] * 4 if name == "c16" else CHAINS[name][0]
    x = torch.from_numpy(_input("c4" if name == "c16" else name, 37, 150, 5))
    kernel = PipelineKernel(fns)
    got = evaluate(kernel.expr, lambda k, dy, dx: x)
    want = stream_pipeline_ref(x, fns)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    assert kernel.ops_per_element() == {"c4": 4, "c16": 16,
                                        "bool_mid": 3}[name]


def test_source_generates_without_nvcc(monkeypatch):
    def no_nvcc(names=()):
        raise build.KernelBuildError("nvcc is not here")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    fns = CHAINS["c4"][0]
    src = PipelineKernel(fns).source
    assert src.count('extern "C" int sp_launch(') == 1
    assert '#include "stream_pipeline.cuh"' in src
    assert "sp::launch<Chain>(in, out, n, vec, unroll, stream)" in src
    assert "(0x1.0000000000000p+1f)" in src      # v * 2.0 as a float32
    path = build.library_path("sp", src)
    assert path == build.library_path("sp", PipelineKernel(fns).source)
    a = PipelineKernel((lambda v: v * 3.0,)).source
    b = PipelineKernel((lambda v: v * 3.0,)).source
    assert build.library_path("sp", a) == build.library_path("sp", b)
    assert build.library_path("sp", a) != path


# (chain, its cost, the unroll at 1080x1920, 2160x3840 and 4320x7680 on
# 132 SMs and a 50 MB L2: the fastest or within 1 % of it, PERF.md)
UNROLL_CASES = [
    ((torch.tanh,), 16, (2, 4, 1)),
    (CHAINS["c4"][0], 26, (2, 4, 1)),
    (CHAINS["c4"][0] * 2, 52, (1, 2, 2)),
    (CHAINS["c4"][0] * 4, 104, (1, 2, 2)),
    ((lambda v: v * 3.0 + 1.0,) * 10, 20, (2, 4, 1)),   # cheap ops
]


@pytest.mark.parametrize("case", range(len(UNROLL_CASES)))
def test_unroll_by_chain_cost_and_plane(case):
    fns, cost, want = UNROLL_CASES[case]
    kernel = PipelineKernel(fns)
    assert kernel.cost_per_element() == cost
    assert (cost > HEAVY_COST) == (want[0] == 1)
    got = tuple(unroll(cost, H * W, 132, 50 * 2**20)
                for H, W in ((1080, 1920), (2160, 3840), (4320, 7680)))
    assert got == want
    # a plane too small to fill one wave at any unroll: 2 light, 1 heavy
    assert unroll(cost, 4096, 132, 50 * 2**20) == (1 if cost > HEAVY_COST
                                                   else 2)


def test_included_headers_reach_the_group_helpers():
    src = PipelineKernel((torch.sign,)).source
    names = [p.name for p in build.included_headers(src)]
    assert names == ["stream_pipeline.cuh", "stream_group.cuh"]
    assert "sg::sign(" in src


# ----------------------------------------------------------------------
# what the kernel does not take (CPU)
# ----------------------------------------------------------------------
def _half_chains(xp):
    """Chains over bf16 / f16 planes in one framework (``xp`` its array
    module), scalars exact in both types: the JAX test's C4; ``exp``, a
    lower bound and a division; and ``exp`` after two rounded operations,
    which turns their rounding into a relative error |arg| times as
    large."""
    floor = ((lambda v: torch.clamp(v, min=0.5)) if xp is torch
             else (lambda v: xp.maximum(v, 0.5)))
    return {"c4": _c4(xp.tanh, xp.abs, xp.sqrt),
            "mix": (xp.exp, lambda v: v * 1.5 - 0.25, floor,
                    lambda v: v / 3.0),
            "exp_after": (lambda v: v * 1.5 - 0.25, xp.exp, floor)}


# bool stage outputs kept bool: ``~v`` and ``v & w`` after a comparison
BOOL_CHAINS = {"not": (lambda v: v > 0.5, lambda v: ~v),
               "and": (lambda v: v > 0.5, lambda v: ~v,
                       lambda v: v & (v | False))}
# over int32 planes: floored // and % of negative values, bit ops, a
# comparison whose bool goes on, true division to float32 cast back
INT_CHAINS = {"arith": (lambda v: v * 3 - 7, lambda v: v // 4,
                        lambda v: v % 5 - 2),
              "bits": (lambda v: (v ^ 6) | 1, lambda v: v & 0x7f,
                       lambda v: v > 2, lambda v: ~v),
              "div": (lambda v: v * 5, lambda v: v / 2,
                      lambda v: v - 0.75)}
# over bool planes
BOOL_PLANE_CHAINS = {"not": (lambda v: ~v, lambda v: v & (v | False)),
                     "xor": (lambda v: v ^ True, lambda v: v | ~v)}
HALF_ULPS = 2                        # port vs JAX, in the plane's type


def _ulps(got, want, dtype):
    """The largest |got - want| in units of the plane type's epsilon x
    |want| (at least its smallest normal)."""
    got, want = np.asarray(got.float()), np.asarray(want, np.float32)
    info = torch.finfo(dtype)
    unit = np.maximum(info.eps * np.abs(want), info.tiny)
    return float((np.abs(got - want) / unit).max())


@pytest.mark.parametrize("fn", [stream_pipeline, stream_pipeline_staged])
def test_typed_errors(fn):
    """What the kernel does not take raises (a 3-D plane, float64: the
    reference turns it into float32 before its kernel, stages outside the
    recorder's op set, a plane on neither the card nor the CPU); bf16 and
    f16 chains hold the JAX kernel within 2 ulp of the plane's type; a
    bool stage output stays bool into the next stage, and int32 and bool
    planes give JAX's result, exact."""
    fns = CHAINS["c4"][0]
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.ones(2, 3, 4), fns)
    with pytest.raises(NotPortedError, match="float64"):
        fn(torch.ones(4, 8, dtype=torch.float64), fns)
    x = torch.ones(4, 8)
    for bad in (lambda v: v if v > 0 else -v,    # Python control flow
                lambda v: v.mean(),               # outside the op set
                lambda v: -v):                    # arithmetic on a bool
        chain = (lambda v: v > 0.5, bad)
        with pytest.raises(UnsupportedBackendError, match="stage 1"):
            fn(x, chain)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(torch.ones(4, 8, device="meta"), fns)
    _needs_jax()
    staged = fn is stream_pipeline_staged
    j_fn = j_staged if staged else functools.partial(
        j_fused, tile=(32, 128), interpret=True)
    rng = np.random.default_rng(9)
    xs = np.abs(rng.normal(size=(57, 300))).astype(np.float32)
    chains, jchains = _half_chains(torch), _half_chains(jnp)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float16, jnp.float16)):
        for name in chains:
            xt = torch.from_numpy(xs).to(dtype)
            got = fn(xt, chains[name])
            assert got.dtype == dtype
            # each op rounded to the plane's type: eager jnp, exactly
            v = jnp.asarray(xs).astype(jdtype)
            for f in jchains[name]:
                v = f(v)
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(v.astype(jnp.float32)))
            # against the Pallas kernel in interpret mode, within 2 ulp;
            # XLA keeps f16 in float32 across the kernel's ops, and an exp
            # after rounded ops turns their one ulp of its argument into
            # |arg| ulp of its result
            bound = HALF_ULPS
            if name == "exp_after":
                bound += float(np.abs(xs * 1.5 - 0.25).max())
            want = j_fn(jnp.asarray(xs).astype(jdtype), jchains[name])
            gap = _ulps(got, np.asarray(want.astype(jnp.float32)), dtype)
            assert gap <= bound, (dtype, name, gap)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(xs - 1.0).to(dtype)
        for chain in BOOL_CHAINS.values():
            got = fn(xt, chain)
            want = np.asarray(j_fn(jnp.asarray(xs - 1.0).astype(jdtype),
                                   chain).astype(jnp.float32))
            assert got.dtype == dtype
            np.testing.assert_array_equal(got.float().numpy(), want)
            assert 0 < float(got.float().sum()) < got.numel()
    # int32 and bool planes: exact against JAX, the result in the plane's
    # type (the reference's staged run leaves the last stage's type)
    xi = rng.integers(-1000, 1000, size=(57, 300)).astype(np.int32)
    for x, chains in ((xi, INT_CHAINS), (xi > 0, BOOL_PLANE_CHAINS)):
        for name, chain in chains.items():
            got = fn(torch.from_numpy(x), chain)
            want = np.asarray(j_fn(jnp.asarray(x), chain)).astype(x.dtype)
            assert got.dtype == torch.from_numpy(x).dtype, name
            np.testing.assert_array_equal(got.numpy(), want)


def test_tile_is_checked():
    x = torch.ones(4, 8)
    fns = CHAINS["c4"][0]
    for tile in ((0, 128), (8,), (8, 1.5)):
        with pytest.raises(ValueError, match="tile"):
            stream_pipeline(x, fns, tile=tile)
    assert torch.equal(stream_pipeline(x, fns, tile=(8, 128)),
                       stream_pipeline(x, fns))


def test_cpu_path_counts_no_launch_and_takes_views():
    fns = CHAINS["c4"][0]
    x = torch.from_numpy(_input("c4", 40, 64, 2))
    before = stream_pipeline.launches
    view = x.t()                       # non-contiguous (64, 40)
    out = stream_pipeline(view, fns)
    staged = stream_pipeline_staged(view, fns)
    assert stream_pipeline.launches == before
    assert out.is_contiguous() and tuple(out.shape) == (64, 40)
    assert torch.equal(out, stream_pipeline_ref(view.contiguous(), fns))
    assert torch.equal(staged, out)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(1080, 1920), (257, 513), (1, 1)])
def test_kernel_matches_plain_version_on_card(H, W):
    _needs_card()
    fns = CHAINS["c4"][0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(H, W, device="cuda", generator=gen).abs()
    before = stream_pipeline.launches
    out = stream_pipeline(x, fns)
    torch.cuda.synchronize()
    assert stream_pipeline.launches == before + 1
    _card_close(out, stream_pipeline_ref(x, fns))


@pytest.mark.gpu
def test_misaligned_view_on_card():
    _needs_card()
    H, W = 257, 513
    fns = CHAINS["c4"][0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    flat = torch.randn(H * W + 1, device="cuda", generator=gen).abs()
    x = flat[1:].view(H, W)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    out = stream_pipeline(x, fns)
    torch.cuda.synchronize()
    _card_close(out, stream_pipeline_ref(x, fns))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_staged_launches_once_per_stage_on_card(name):
    _needs_card()
    fns = CHAINS[name][0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(300, 700, device="cuda", generator=gen)
    if CHAINS[name][1]:
        x = x.abs()
    before = stream_pipeline.launches
    out = stream_pipeline_staged(x, fns)
    torch.cuda.synchronize()
    assert stream_pipeline.launches == before + len(fns)
    _card_close(out, stream_pipeline_ref(x, fns))


@pytest.mark.gpu
@pytest.mark.parametrize("u", [1, 2, 4])
def test_every_unroll_matches_plain_on_card(u):
    """Each unroll the launcher can pick, on a ragged plane and on a
    misaligned view of it (the scalar walk)."""
    _needs_card()
    fns = CHAINS["c4"][0]
    kernel = PipelineKernel(fns)
    gen = torch.Generator(device="cuda").manual_seed(4)
    flat = torch.randn(257 * 513 + 1, device="cuda", generator=gen).abs()
    for x in (flat[:-1].view(257, 513), flat[1:].view(257, 513)):
        out = kernel.launch(x, u)
        torch.cuda.synchronize()
        _card_close(out, stream_pipeline_ref(x, fns))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(1079, 1917), (3, 5)])
def test_one_stage_ragged_and_misaligned_on_card(H, W):
    """C1 (``tanh``) with n % 16 != 0: the last block's vectors run out
    mid-block and the last n % 4 values take the scalar tail; then the
    same plane as a view whose data is not 16-byte aligned (the scalar
    walk)."""
    _needs_card()
    fns = (torch.tanh,)
    gen = torch.Generator(device="cuda").manual_seed(3)
    flat = torch.randn(H * W + 1, device="cuda", generator=gen)
    x = flat[:-1].view(H, W)
    xm = flat[1:].view(H, W)
    assert x.numel() % 16 != 0 and x.data_ptr() % 16 == 0
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    before = stream_pipeline.launches
    out, outm = stream_pipeline(x, fns), stream_pipeline(xm, fns)
    torch.cuda.synchronize()
    assert stream_pipeline.launches == before + 2
    _card_close(out, stream_pipeline_ref(x, fns))
    _card_close(outm, stream_pipeline_ref(xm, fns))


def _card_ulps(got, want):
    """Kernel vs plain on the card in units of the plane type's epsilon
    x |plain| (NaN where the plain version has NaN)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    info = torch.finfo(want.dtype)
    unit = (info.eps * want.float().abs()).clamp_min(info.tiny)
    return float(((got.float() - want.float()).abs() / unit)[~nan].max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_planes_match_plain_on_card(dtype):
    """bf16 / f16 chains, fused and staged, on a plane and a ragged,
    misaligned view (the scalar walk): within 1 ulp of the plain
    version's per-op rounding."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = torch.randn(257 * 513 + 1, device="cuda", generator=gen).abs()
    for x in (torch.randn(1080, 1920, device="cuda", generator=gen).abs(),
              flat[1:].view(257, 513)):
        x = x.to(dtype)
        for name, fns in _half_chains(torch).items():
            before = stream_pipeline.launches
            out = stream_pipeline(x, fns)
            staged = stream_pipeline_staged(x, fns)
            torch.cuda.synchronize()
            assert stream_pipeline.launches == before + 1 + len(fns)
            want = stream_pipeline_ref(x, fns)
            assert _card_ulps(out, want) <= 1.0, name
            assert _card_ulps(staged, want) <= 1.0, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bool_stage_outputs_stay_bool_on_card(dtype):
    """``~v`` and ``v & w`` after a comparison, fused and staged (the
    staged run keeps the comparison's bool in memory): exact."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(1079, 1917, device="cuda", generator=gen).to(dtype)
    for fns in BOOL_CHAINS.values():
        out = stream_pipeline(x, fns)
        staged = stream_pipeline_staged(x, fns)
        want = stream_pipeline_ref(x, fns)
        torch.cuda.synchronize()
        assert out.dtype == dtype and torch.equal(out, want)
        assert torch.equal(staged, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_int_and_bool_planes_match_plain_on_card(dtype):
    """int32 and bool planes (4-byte and 1-byte values, 4 and 16 to a
    16-byte step), fused and staged, on a ragged plane and a misaligned
    view of it (the scalar walk): exact."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    flat = torch.randint(-1000, 1000, (1079 * 1917 + 1,), device="cuda",
                         generator=gen, dtype=torch.int32)
    chains = INT_CHAINS
    if dtype == torch.bool:
        flat, chains = flat > 0, BOOL_PLANE_CHAINS
    for x in (flat[:-1].view(1079, 1917), flat[1:].view(1079, 1917)):
        for name, fns in chains.items():
            before = stream_pipeline.launches
            out = stream_pipeline(x, fns)
            staged = stream_pipeline_staged(x, fns)
            torch.cuda.synchronize()
            assert stream_pipeline.launches == before + 1 + len(fns)
            want = stream_pipeline_ref(x, fns)
            assert out.dtype == dtype and torch.equal(out, want), name
            assert torch.equal(staged, want), name
