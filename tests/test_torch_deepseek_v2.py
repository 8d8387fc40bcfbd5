"""deepseek-v2-lite in the port: MLA with no q LoRA under YaRN, a leading
dense layer, then dropless top-K routing with shared experts
(``configs/deepseek_v2_lite.py``), held at its float32 smoke size against
the benchmark's plain reference (``bench/reference/families/
deepseek_v2.py``, plain PyTorch that imports nothing of the port) on
weights drawn from a seed; the dispatch and the plain version of the
routed experts' kernel (``kernels/moe_experts.py``); and, on the card,
the kernel against its plain version at the published widths, captured
and eager, and the smoke model's decode step as one graph.  (The
latent decode at the published G 16, Dk 576, Dv 512 is a case of
``tests/test_torch_moe_mla.py``'s ``LATENT_SHAPES``.)"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_v2_lite as DS
from repro_torch.kernels import build
from repro_torch.kernels import moe_experts as ME
from repro_torch.kernels.ref import moe_experts_ref
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.runtime.batcher import ContinuousBatcher, Request

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.counts.families import deepseek_v2 as DC  # noqa: E402
from bench.reference import check  # noqa: E402
from bench.reference import model as R  # noqa: E402
from bench.reference.families import deepseek_v2 as DR  # noqa: E402
from bench.reference.weights import make_weights  # noqa: E402

torch.set_num_threads(1)
CFG = DS.SMOKE
SEED = 2**31 + 33
#: the benchmark's sizes of the smoke config: every field its file names
SIZES = {**{k: v for k, v in dataclasses.asdict(CFG).items()
            if k in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                     "d_ff", "vocab_size", "head_dim", "tie_embeddings",
                     "norm_eps", "rope_theta", "dtype", "n_experts",
                     "experts_per_token", "kv_lora_rank", "rope_head_dim",
                     "first_dense_layers", "dense_d_ff", "n_shared_experts",
                     "moe_renorm", "rope_factor", "rope_original_len",
                     "rope_beta_fast", "rope_beta_slow", "rope_mscale",
                     "rope_mscale_all_dim")},
         "family": "deepseek_v2"}
#: float32 on both sides, the sums in another order: the logits agree to
#: a few float32 roundings of their size, far below what a changed
#: token, a dropped choice or a renormalised gate moves (tested below)
RTOL = 1e-4


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


@pytest.fixture(scope="module")
def params():
    return make_weights(SIZES, SEED, "cpu")


def _tokens(n, seed):
    return torch.randint(0, CFG.vocab_size, (n,),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, rtol=RTOL):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


def test_the_ports_tree_is_the_references(params):
    """The benchmark draws the weights; the port must take them as its
    own tree: the same keys and shapes as ``param_defs``."""
    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    def defs(t):
        return {k: defs(v) if isinstance(v, dict) else v.shape
                for k, v in t.items()}
    assert shapes(params) == defs(TM.param_defs(CFG))
    assert "wdq" not in params["blocks"]["attn"]       # no q LoRA
    assert params["dense_blocks"]["mlp"]["wg"].shape == (1, 64, 96)


def test_forward_matches_the_reference(params):
    seq = _tokens(23, 1)
    logits, aux = TM.forward(params, CFG, seq[None])
    _close(logits[0], R.logits(params, SIZES, seq))
    assert float(aux) == 0.0


def test_prefill_then_decode_match_the_full_forward(params):
    """Prefill, then decode through the latent cache of all three
    layers, against the reference's full forward at each position."""
    seq = _tokens(20, 2)
    want = R.logits(params, SIZES, seq)
    cache = TM.init_cache(CFG, 1, 32, torch.float32, "cpu")
    assert cache["attn"]["c_kv"].shape == (3, 1, 32, 32)
    got, cache = TM.prefill(params, CFG, seq[None, :12], cache)
    _close(got[0], want[11])
    for j in range(12, 20):
        got, cache = TM.decode_step(params, CFG, seq[j:j + 1], cache)
        _close(got[0], want[j])


def test_the_batcher_serves_the_references_tokens(params):
    """ContinuousBatcher's greedy tokens, two slots, every served token
    the reference's own first choice (``served_gap`` 0 up to float32
    rounding)."""
    b = ContinuousBatcher(CFG, params, 2, 48, dtype=torch.float32,
                          device="cpu")
    reqs = [Request(rid=i, prompt=np.asarray(_tokens(n, 10 + i),
                                             dtype=np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(((7, 12), (15, 9), (4, 14)))]
    for r in reqs:
        b.submit(r)
    for _ in range(60):
        b.step()
    assert len(b.finished) == 3
    served = [(np.asarray(r.prompt), list(r.tokens)) for r in reqs]
    assert check.served_gap(params, SIZES, served, "cpu") < 1e-3


def _moe_layer(params):
    return {k: v[0] for k, v in params["blocks"]["mlp"].items()
            if k != "shared"} | {"shared": {k: v[0] for k, v in
                                params["blocks"]["mlp"]["shared"].items()}}


def test_every_token_reaches_one_expert_without_a_drop(params):
    """Tokens near one direction and a router column along it: expert 0
    comes first for all 12 tokens, 3 choices each (a capacity route
    would keep ceil(12 * 3 / 8 * 1.25) = 6 of its 12).  The layer equals
    the reference's, which runs each expert over exactly its tokens;
    without expert 0's rows it would not."""
    p = {**_moe_layer(params)}
    router = p["router"].clone()
    router[:, 0] = 0.05                 # a logit of ~3.2 against ~0.16
    p["router"] = router
    g = torch.Generator().manual_seed(3)
    x = 1.0 + 0.1 * torch.randn(1, 12, CFG.d_model, generator=g)
    _, _, topw, tope = L.moe_route(p, CFG, x)
    assert bool((tope[..., 0] == 0).all())
    got, aux = L.moe_block(p, CFG, x)
    with R.exact_matmul():
        want = DR.moe(p, SIZES, x, "f32")
    _close(got, want, 1e-5)
    assert float(aux) == 0.0
    # expert 0's share of each token's output is far above the agreement
    h = L.rmsnorm(x, p["ln"], CFG.norm_eps)[0]
    y0 = torch.nn.functional.silu(h @ p["wg"][0]) * (h @ p["wu"][0]) \
        @ p["wd"][0]
    part = topw[0, :, 0, None] * y0
    assert float(part.abs().max()) > 1e3 * float((got - want).abs().max())


def test_the_gates_are_not_renormalised(params):
    p = _moe_layer(params)
    x = torch.randn(2, 5, CFG.d_model, generator=torch.Generator()
                    .manual_seed(4))
    _, gates, topw, tope = L.moe_route(p, CFG, x)
    assert torch.equal(topw, gates.gather(-1, tope))
    assert float(topw.sum(-1).max()) < 0.99            # K of E, raw
    got, _ = L.moe_block(p, CFG, x)
    renorm = dataclasses.replace(CFG, moe_renorm=True)
    other, _ = L.moe_block(p, renorm, x)
    with R.exact_matmul():
        want = DR.moe(p, SIZES, x, "f32")
    _close(got, want, 1e-5)
    assert float((other - want).abs().max()) > 1e3 * float(
        (got - want).abs().max())


@pytest.mark.parametrize("change", [{"n_shared_experts": 1},
                                    {"moe_renorm": False}])
def test_the_capacity_route_refuses_what_it_does_not_run(change):
    """Shared experts and raw gates run only on the dropless route: a
    config that asks the capacity route for them is refused, not served
    as another model.  Neither alone is refused on the dropless route."""
    base = dataclasses.replace(CFG, n_shared_experts=0, moe_renorm=True,
                               moe_dropless=False)
    assert not base.moe_dropless
    with pytest.raises(ValueError, match="dropless"):
        dataclasses.replace(base, **change)
    assert dataclasses.replace(base, moe_dropless=True, **change).moe_dropless


def test_extended_defaults_are_every_configs():
    """Every ModelConfig reads ExtendedConfig's defaults (one source),
    and its fields, hence its asdict, stay the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ExtendedConfig, ModelConfig
    cfg = get_config("granite_moe_3b_a800m")
    own = {f.name for f in dataclasses.fields(ModelConfig)}
    extra = [f for f in dataclasses.fields(ExtendedConfig)
             if f.name not in own]
    assert len(extra) == 11
    for f in extra:
        assert getattr(cfg, f.name) == f.default, f.name
        assert f.name not in dataclasses.asdict(cfg)


def test_yarn_at_the_published_values():
    """DeepSeek-V2-Lite's YaRN over its 64 rope dims: the ramp from
    dim 10 to 23, factor 40, mscale 0.707 both ways (cos and sin
    unscaled), and the softmax scale m(40, 0.707)^2 / sqrt(192)."""
    cfg = DS.CONFIG
    yarn = L.yarn_of(cfg)
    freqs, mscale = L.rope_freqs(64, cfg.rope_theta, yarn, torch.device("cpu"))
    plain, _ = L.rope_freqs(64, cfg.rope_theta, None, torch.device("cpu"))
    assert mscale == 1.0
    i = torch.arange(32)
    assert torch.equal(freqs[i <= 10], plain[i <= 10])       # extrapolated
    _close(freqs[i >= 23], plain[i >= 23] / 40.0, 1e-6)       # interpolated
    mid = freqs[11:23]
    assert bool(((mid < plain[11:23]) & (mid > plain[11:23] / 40)).all())
    ramp = (i[11:23].float() - 10) / 13
    _close(mid, plain[11:23] / 40 * ramp + plain[11:23] * (1 - ramp), 1e-6)
    scale = cfg.yarn_mscale / math.sqrt(128 + 64)
    assert abs(scale - 0.114721) < 1e-6
    assert abs(scale - DR.softmax_scale(
        {**SIZES, **dataclasses.asdict(cfg)})) < 1e-9
    ref, ref_m = DR.yarn({**SIZES, **dataclasses.asdict(cfg)}, "cpu")
    _close(freqs, ref, 1e-6)
    assert ref_m == 1.0


def test_the_published_parameter_count():
    cfg = DS.CONFIG
    assert cfg.n_params() == 15_706_470_400          # 15.71 B
    assert round(cfg.n_params() / 1e9, 2) == 15.71
    # the base's rule, with the embedding table: 2.66 B; what a token is
    # multiplied by (no embedding lookup, the benchmark's count): 2.45 B
    assert cfg.n_active_params() == 2_661_136_384
    sz = {**dataclasses.asdict(cfg), "family": "deepseek_v2"}
    assert DC.weights_per_token(sz) == 2_451_308_544
    norms = cfg.n_layers * 2 * cfg.d_model + cfg.d_model
    assert cfg.n_active_params() - cfg.vocab_size * cfg.d_model - norms \
        == DC.weights_per_token(sz)


# ----------------------------------------------------------------------
# the dispatch and the routed experts' plain version
# ----------------------------------------------------------------------
def test_the_dispatch_sorts_by_expert():
    experts = torch.tensor([[3, 0, 5], [0, 5, 1], [5, 3, 0], [1, 0, 3]])
    gates = torch.rand(4, 3, generator=torch.Generator().manual_seed(5))
    r = ME.dispatch(experts, gates, 8)
    assert r.offsets.tolist() == [0, 4, 6, 6, 9, 9, 12, 12, 12]   # 2, 4, 6, 7 empty
    assert r.rows.tolist() == [0, 1, 2, 3, 1, 3, 0, 2, 3, 0, 1, 2]
    ids = experts.reshape(-1)
    sorted_ids = torch.repeat_interleave(torch.arange(8), torch.diff(
        r.offsets.long()))
    for t in range(4):
        rows = r.slots[t].tolist()
        assert rows == sorted(rows)
        assert sorted(sorted_ids[rows].tolist()) == sorted(
            experts[t].tolist())
        assert all(r.rows[p] == t for p in rows)
    order = torch.sort(ids, stable=True).indices
    assert torch.equal(r.gates, gates.reshape(-1)[order])
    assert r.rows.dtype == r.offsets.dtype == r.slots.dtype == torch.int32


def _naive(h, experts, gates, wg, wu, wd):
    out = torch.zeros(h.shape, dtype=torch.float64)
    for t in range(h.shape[0]):
        for j in sorted(range(experts.shape[1]),
                        key=lambda j: int(experts[t, j])):
            e = int(experts[t, j])
            x = h[t].double()
            a = torch.nn.functional.silu(x @ wg[e].double()) * (
                x @ wu[e].double())
            a = a.to(h.dtype).double()
            out[t] += float(gates[t, j]) * (a @ wd[e].double())
    return out


@pytest.mark.parametrize("case", ["random", "all_to_one", "one_token"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_experts_against_a_loop(case, dtype):
    """Each token's K gated SwiGLU outputs, summed: against a loop over
    tokens in float64 (a rounded to the inputs' type, as the kernel
    rounds it); every expert but K empty when all tokens choose the
    same ones."""
    g = torch.Generator().manual_seed(6)
    E, K, d, f = 8, 3, 16, 24
    T = 1 if case == "one_token" else 10
    h = torch.randn(T, d, generator=g).to(dtype)
    wg = (torch.randn(E, d, f, generator=g) / 4).to(dtype)
    wu = (torch.randn(E, d, f, generator=g) / 4).to(dtype)
    wd = (torch.randn(E, f, d, generator=g) / 5).to(dtype)
    if case == "all_to_one":
        experts = torch.tensor([4, 1, 6]).expand(T, K).contiguous()
    else:
        experts = torch.rand(T, E, generator=g).topk(K, -1).indices
    gates = torch.rand(T, K, generator=g)
    r = ME.dispatch(experts, gates, E)
    got = ME.moe_experts(h, r, wg, wu, wd)           # the CPU: plain
    assert got.dtype == torch.float32
    want = _naive(h, experts, gates, wg, wu, wd)
    # float32 sums against float64, and where bf16, a's rounding may
    # fall on either side: two bf16 ulps of the largest output
    tol = 2e-5 if dtype == torch.float32 else 2 * 2.0 ** -8
    assert float((got.double() - want).abs().max()) <= \
        tol * float(want.abs().max())
    assert int((torch.diff(r.offsets.long()) == 0).sum()) >= \
        (E - K if case != "random" else 0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card_experts(T, forced=None, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E, K, d, f = 64, 6, 2048, 1408                   # deepseek-v2-lite
    h = torch.randn(T, d, device=dev, generator=g).bfloat16()
    wg = (torch.randn(E, d, f, device=dev, generator=g) / 45).bfloat16()
    wu = (torch.randn(E, d, f, device=dev, generator=g) / 45).bfloat16()
    wd = (torch.randn(E, f, d, device=dev, generator=g) / 38).bfloat16()
    gates = torch.softmax(torch.randn(T, E, device=dev, generator=g), -1)
    w, e = gates.topk(K, -1)
    if forced is not None:
        e = forced.to(dev)
        w = gates.gather(-1, e)
    return h, ME.dispatch(e, w, E), wg, wu, wd


@pytest.mark.gpu
@pytest.mark.parametrize("T,forced", [(1, None), (64, None), (161, None),
                                      (300, None), (602, None),
                                      (602, "all_to_one")])
def test_the_experts_kernel_matches_plain_on_card(T, forced):
    """At the published widths (d 2048, f 1408, 64 experts, top 6): a
    decode step's T = 1 and 64, the gen mix's mean and longest prompt,
    a prompt of 300 (row tiles of 32: ``plan``'s mt 2; 602 takes mt 4,
    the rest mt 1), and every token on experts 0-5 (602 rows for each,
    58 experts with no row).  Against the plain version computed on
    the card: the same bf16 rounding of a, float32 sums in another
    order, so a's rounding may land on the other side: 2e-3 of the
    largest output, the bf16 ulp's half.  Two calls equal bit for
    bit."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    one = torch.arange(6).expand(T, 6).contiguous() if forced else None
    h, r, wg, wu, wd = _card_experts(T, one)
    before = ME.moe_experts.launches
    got = ME.moe_experts(h, r, wg, wu, wd)
    again = ME.moe_experts(h, r, wg, wu, wd)
    want = moe_experts_ref(h, r.rows, r.offsets, r.gates, r.slots, wg, wu,
                           wd)
    torch.cuda.synchronize()
    assert ME.moe_experts.launches == before + 2
    assert float((got - want).abs().max()) <= 2e-3 * float(want.abs().max())
    assert torch.equal(got, again)
    if forced:
        assert int((torch.diff(r.offsets.long()) == 0).sum()) == 58


@pytest.mark.gpu
def test_the_experts_kernel_is_the_same_captured_on_card():
    """The dispatch and the kernel captured in one CUDA graph give the
    eager call's bits: no host read, no shape from the data, no
    atomics."""
    _needs_card()
    h, _, wg, wu, wd = _card_experts(64)
    logits = torch.randn(64, 64, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))

    def step():
        w, e = torch.softmax(logits, -1).topk(6, -1)
        return ME.moe_experts(h, ME.dispatch(e, w, 64), wg, wu, wd)
    eager = step()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.gpu
def test_the_smoke_model_decodes_in_one_graph_on_card():
    """The smoke config in bf16 through the batcher on the card: the
    decode step captured once, the routed experts in it counted each
    step, its logits within bf16 of the eager model's."""
    _needs_card()
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    p = make_weights({**SIZES, "dtype": "bfloat16"}, SEED, "cuda")
    b = ContinuousBatcher(cfg, p, 2, 48, dtype=torch.float32, device="cuda")
    for i, n in enumerate((7, 15)):
        b.submit(Request(rid=i, prompt=np.asarray(_tokens(n, 20 + i),
                                                  dtype=np.int32),
                         max_new_tokens=10))
    for _ in range(12):
        b.step()
    torch.cuda.synchronize()
    step = b.compiled
    assert step.captures == 1
    assert step.step_launches["moe_experts"] == cfg.n_layers - 1
