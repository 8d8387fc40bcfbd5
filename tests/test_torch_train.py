"""The port's training path against the JAX package's, on the CPU:
``loss_fn`` and its gradients for every family, ``make_train_step``
against the reference's jitted step, the kernels' autograd Functions,
and ``remat``.

Every model is a ``SMOKE`` config in float32 with the reference's
parameters carried across (``from_jax_params`` / ``from_jax_train_state``)
and inputs from a numpy seed; the JAX side runs as its own tests run it
(``jax.value_and_grad(M.loss_fn)``, ``jax.jit(make_train_step(...))``,
``impl="auto"``, which on the CPU is its plain route).

Tolerances: the loss within 1e-5 x |ref| + 1e-6; each gradient leaf
within 1e-5 x max|ref| + 1e-5 x |ref| (summation order only, the port's
parity bound); train-step metrics within 1e-5; after 3 steps params,
master, m and v within 1e-4 x max|ref| per leaf (see
``test_train_step_matches_jax``).  Each test reports its max abs error.

On the CPU the kernels' wrappers run their plain versions, so the
autograd Functions (``kernels/autograd.py``) are reached by replacing
``ops.uses_kernel`` and the kernel wrappers with counting plain
versions (``fake_kernels``).  Tests marked ``gpu`` run the kernel route
on the card against ``impl="ref"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import autograd as AG  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_mlp_backward as MB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig as TAdamW  # noqa: E402
from repro_torch.optim.adamw import (adamw_init, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.runtime import steps as tsteps  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_init as j_adamw_init
    from repro.kernels import ref as JR
    from repro.optim.compression import ef_init as j_ef_init
    from repro.runtime.steps import make_train_step as j_make_train_step
except ImportError:
    jax = None

FAMILIES = ("granite_3_2b", "granite_moe_3b_a800m", "minicpm3_4b",
            "mamba2_2p7b", "zamba2_1p2b", "whisper_base", "internvl2_26b")
CPU = torch.device("cpu")
B, S = 2, 8


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


def _batch(cfg, seed=0, b=B, s=S) -> dict:
    """tokens, labels (some -1) and the family's frontend, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    labels[-1, -1] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.family in ("vlm", "encdec"):
        key = "extra_embeds" if cfg.family == "vlm" else "enc_embeds"
        out[key] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch, device=CPU) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _grads(params, cfg, batch):
    """(total, metrics, {dotted name: gradient or None})."""
    names = _names(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, met = TM.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return (total.detach(), {k: v.detach() for k, v in met.items()},
            dict(zip(names, grads)))


def _names(tree, prefix=""):
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree)
            for n in _names(tree[k], f"{prefix}.{k}" if prefix else k)]


def _flat_np(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree, np.float64)}
    out = {}
    for k in sorted(tree):
        out.update(_flat_np(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def _leaf_close(got, want, rtol=1e-5) -> float:
    """got within rtol x max|want| + rtol x |want|; the max abs error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = rtol * np.abs(want).max() + rtol * np.abs(want)
    assert np.all(err <= tol), float(err.max())
    return float(err.max())


def _pair(arch, **over):
    _needs_jax()
    cfg = dataclasses.replace(jconfigs.get_smoke(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **over)
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    return cfg, jp, tcfg, TM.from_jax_params(
        tcfg, jax.tree.map(np.asarray, jp), CPU)


# ----------------------------------------------------------------------
# loss_fn and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    """Every family's loss, metrics and every gradient leaf against
    ``jax.value_and_grad(repro.models.model.loss_fn)``; for MoE the
    experts each layer chose equal the reference's (its router in an
    unrolled forward, ``top_k`` recorded)."""
    cfg, jp, tcfg, tp = _pair(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    with TL.expert_choices() as rec:
        tl, tm, tg = _grads(tp, tcfg, _torch(batch))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)) + 1e-6
    for k in ("loss", "aux", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-5 * abs(float(jm[k])) + 1e-6, k
    want = _flat_np(jax.tree.map(np.asarray, jg))
    assert set(want) == set(tg)
    err = max(_leaf_close(tg[k].numpy() if tg[k] is not None
                          else np.zeros(want[k].shape), want[k])
              for k in want)
    print(f"{arch}: loss {float(tl)} (jax {float(jl)}), grad max abs "
          f"err {err:.3e}")
    if cfg.n_experts:
        taken = []
        plain = jax.lax.top_k

        def top_k(x, k):
            out = plain(x, k)
            taken.append(np.asarray(out[1]))
            return out
        monkeypatch.setattr(jax.lax, "top_k", top_k)
        JM.forward(jp, dataclasses.replace(cfg, scan_layers=False,
                                           remat="none"),
                   jnp.asarray(batch["tokens"]))
        # one record a layer: the recompute under remat records nothing
        assert len(rec.chosen) == len(taken) == cfg.n_layers
        assert all(np.array_equal(t.numpy(), j)
                   for t, j in zip(rec.chosen, taken))


def test_loss_ignores_negative_labels_and_vlm_prefix():
    """labels < 0 carry no loss; a vlm's prefix positions are dropped
    before the cross entropy."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    total, met = TM.loss_fn(params, cfg, batch)
    logits, _ = TM.forward(params, cfg, batch["tokens"])
    keep = batch["labels"] >= 0
    ce = TL.softmax_cross_entropy(logits, batch["labels"].clamp_min(0))
    assert torch.allclose(total, ce[keep].mean(), rtol=1e-6)
    assert float(met["tokens"]) == float(keep.sum())
    vlm = tconfigs.get_smoke("internvl2_26b")
    vp = TM.init(vlm, 0, device="cpu")
    vb = _torch(_batch(vlm))
    full, _ = TM.forward(vp, vlm, vb["tokens"],
                         extra_embeds=vb["extra_embeds"])
    assert full.shape[1] == vlm.n_frontend_tokens + S
    total, _ = TM.loss_fn(vp, vlm, vb)
    keep = vb["labels"] >= 0
    ce = TL.softmax_cross_entropy(full[:, -S:], vb["labels"].clamp_min(0))
    assert torch.allclose(total, ce[keep].mean(), rtol=1e-6)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
STEP_CASES = {"plain": ({}, False), "microbatches=2": ({"microbatches": 2},
                                                      False),
              "compress_grads": ({}, True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """3 steps of ``make_train_step`` against the reference's jitted step
    from the same state.  The metrics within 1e-5 (relative; lr exact to
    float32).  params, master, m and v within 1e-4 x max|ref| per leaf,
    not 1e-5: Adam's m / sqrt(v) is about sign(g) for every element, so
    an element whose gradient is near 0 moves by about lr whatever its
    size, and the 1e-6 differences of such near-zero gradients can flip
    the sign of its step (lr 3e-4, the config's default).  With
    ``compress_grads`` the int8 payload of an element whose scaled value
    lies within those differences of a half rounds the other way, one
    quantum q (max|g| / 127) off.  So each leaf is within 1e-4 x max|ref|
    beyond at most 0.1 % of its elements, and those few within what a
    flipped quantum can move them: m by (1 - b1) q, within 1/127 of
    max|m|; v by (1 - b2)(2|g| + q) q, within 2/127 of max|v|; params and
    master by at most 2 lr a step (|m^ / sqrt(v^)| <= 1 over the first
    three steps at b1 0.9, b2 0.95, so a flip turns an update by at most
    2 lr), so within 2 x the sum of the steps' lr.  grad_norm (after the
    roundtrip) within 1e-4; the payload itself is held exactly in
    ``tests/test_torch_trainer.py``."""
    over, compress = STEP_CASES[case]
    cfg, jp, tcfg, _ = _pair("granite_3_2b", **over)
    js = {"params": jp, "opt": j_adamw_init(jp)}
    if compress:
        js["ef"] = j_ef_init(jp)
    ts = TM.from_jax_train_state(tcfg, jax.tree.map(np.asarray, js), CPU)
    opt = dict(warmup_steps=2, decay_steps=10)
    jstep = jax.jit(j_make_train_step(cfg, JAdamW(**opt),
                                      compress_grads=compress))
    tstep = tsteps.make_train_step(tcfg, TAdamW(**opt),
                                   compress_grads=compress)
    worst, lr_sum = 0.0, 0.0
    for s in range(3):
        batch = _batch(cfg, seed=10 + s, b=4)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, _torch(batch))
        lr_sum += float(jm["lr"])
        assert set(tm) == set(jm)
        for k in jm:
            tol = 1e-4 if compress and k == "grad_norm" else 1e-5
            err = abs(float(tm[k]) - float(jm[k]))
            assert err <= tol * abs(float(jm[k])) + 1e-7, (s, k, err)
            worst = max(worst, err)
    assert int(ts["opt"]["step"]) == 3
    want = _flat_np(jax.tree.map(np.asarray, {"params": js["params"],
                                              "opt": js["opt"]}))
    got = _flat_np(TM.to_numpy({"params": ts["params"], "opt": ts["opt"]}))
    state_err = 0.0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        scale = np.abs(w).max()
        state_err = max(state_err, float(err.max()))
        if not compress:
            assert float(err.max()) <= 1e-4 * scale, k
            continue
        assert np.mean(err > 1e-4 * scale) <= 1e-3, k
        flip = (scale / 127 if k.startswith("opt.m.")
                else 2 * scale / 127 if k.startswith("opt.v.")
                else 2 * lr_sum)
        assert float(err.max()) <= 1e-4 * scale + flip, k
    print(f"{case}: metrics max abs err {worst:.3e}, state max abs err "
          f"{state_err:.3e}")


def test_train_step_refuses_a_mesh():
    """The sharded step (``tests/test_torch_sharded_steps.py``) refuses
    a state that is not sharded over its mesh, and runs one that is."""
    from repro_torch.parallel.sharding import make_mesh
    cfg = tconfigs.get_smoke("granite_3_2b")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    step = tsteps.make_train_step(cfg, TAdamW(), mesh=mesh)
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    with pytest.raises(TypeError, match="ShardedTensor"):
        step({"params": params, "opt": adamw_init(params)}, batch)
    state = tsteps.shard_train_state(params, tsteps.train_state_shardings(
        cfg, mesh))
    _, met = step(state, batch)
    assert np.isfinite(float(met["loss"])) and int(state["opt"]["step"]) == 1


def test_abstract_train_state_matches_a_fresh_one():
    for arch in ("granite_3_2b", "zamba2_1p2b"):
        cfg = tconfigs.get_smoke(arch)
        params = TM.init(cfg, 0, device="cpu")
        real = {"params": params, "opt": adamw_init(params)}
        like = tsteps.abstract_train_state(cfg)
        assert _names(like) == _names(real)
        for a, b in zip(tree_leaves(like), tree_leaves(real)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert a.device.type == "meta"


# ----------------------------------------------------------------------
# the kernels' autograd Functions
# ----------------------------------------------------------------------
class _Fakes:
    """Counting stand-ins for the three kernel wrappers: the plain
    version, a launch counted per call."""

    def __init__(self):
        self.launches = {"flash_attention": 0, "fused_mlp": 0,
                         "ssd_scan": 0}

    def flash(self, q, k, v, bias=None, causal=True, scale=None):
        self.launches["flash_attention"] += 1
        return R.flash_attention_ref(q, k, v, bias=bias, causal=causal,
                                     scale=scale)

    def mlp(self, x, w_norm, w_gate, w_up, w_down, eps=1e-6):
        self.launches["fused_mlp"] += 1
        return R.fused_mlp_ref(x, w_norm, w_gate, w_up, w_down, eps=eps)

    def ssd(self, x, dt, A, B, C, chunk=64, init_state=None):
        self.launches["ssd_scan"] += 1
        return R.ssd_ref(x, dt, A, B, C, chunk=chunk, init_state=init_state)

    def backward_calls(self) -> dict:
        return {"flash_attention": self.flash.backward_calls,
                "fused_mlp": self.mlp.backward_calls,
                "ssd_scan": self.ssd.backward_calls}


@pytest.fixture
def fake_kernels(monkeypatch):
    """ops takes the kernel route on CPU tensors; the wrappers ops and
    the Functions call are the counting plain versions of ``_Fakes``
    (each with the ``backward_calls`` attribute the Functions add to)."""
    fakes = _Fakes()
    for name, fn in (("_flash_kernel", fakes.flash),
                     ("_mlp_kernel", fakes.mlp),
                     ("_ssd_kernel", fakes.ssd)):
        wrapper = _counted(fn)
        monkeypatch.setattr(ops, name, wrapper)
        monkeypatch.setattr(AG, name, wrapper)
        setattr(fakes, name[1:].split("_")[0], wrapper)
    monkeypatch.setattr(ops, "uses_kernel", lambda impl, x: impl != "ref")
    return fakes


def _counted(fn):
    def wrapper(*a, **kw):
        return fn(*a, **kw)
    wrapper.backward_calls = 0
    wrapper.tc_backward_calls = 0
    return wrapper


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, dtype=torch.float64) * scale


def _function_cases(gen):
    """(name, Function, differentiable inputs, other args, plain fn)."""
    q, k, v = _rand(gen, 2, 4, 5, 8), _rand(gen, 2, 2, 7, 8), \
        _rand(gen, 2, 2, 7, 6)
    bias = _rand(gen, 2, 7)
    d, f = 6, 10
    mlp_in = (_rand(gen, 5, d), 1 + 0.1 * _rand(gen, d),
              _rand(gen, d, f, scale=d ** -0.5),
              _rand(gen, d, f, scale=d ** -0.5),
              _rand(gen, f, d, scale=f ** -0.5))
    b, s, h, p, g, n = 1, 6, 2, 3, 1, 4
    ssd_in = (_rand(gen, b, s, h, p),
              torch.rand(b, s, h, generator=gen, dtype=torch.float64) * 0.2
              + 0.01,
              -(torch.rand(h, generator=gen, dtype=torch.float64) + 0.5),
              _rand(gen, b, s, g, n), _rand(gen, b, s, g, n),
              _rand(gen, b, h, p, n))
    return [
        ("flash_attention", AG.FlashAttentionFn, (q, k, v, bias),
         lambda q, k, v, bias: AG.FlashAttentionFn.apply(q, k, v, bias, True,
                                                         None),
         lambda q, k, v, bias: R.flash_attention_ref(q, k, v, bias=bias,
                                                     causal=True)),
        ("fused_mlp", AG.FusedMlpFn, mlp_in,
         lambda *a: AG.FusedMlpFn.apply(*a, 1e-6),
         lambda *a: R.fused_mlp_ref(*a, eps=1e-6)),
        ("ssd_scan", AG.SsdScanFn, ssd_in,
         lambda x, dt, A, B, C, i0: AG.SsdScanFn.apply(x, dt, A, B, C, 4,
                                                       i0),
         lambda x, dt, A, B, C, i0: R.ssd_ref(x, dt, A, B, C, chunk=4,
                                              init_state=i0)),
    ]


@pytest.mark.parametrize("which", ["flash_attention", "fused_mlp",
                                   "ssd_scan"])
def test_function_gradcheck(which, fake_kernels):
    """``torch.autograd.gradcheck`` in float64 at tiny shapes through
    each Function (the scan's y and final state both reach the loss),
    then its gradients of every input equal the plain route's autograd;
    one launch a forward, one plain backward a backward."""
    gen = torch.Generator().manual_seed(3)
    name, _, inputs, fn, plain = next(
        c for c in _function_cases(gen) if c[0] == which)
    ins = [t.clone().requires_grad_(True) for t in inputs]
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7)
    before = dict(fake_kernels.launches)
    calls = fake_kernels.backward_calls()[name]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    gouts = [torch.randn(o.shape, generator=gen, dtype=o.dtype)
             for o in outs]
    got = torch.autograd.grad(outs, ins, gouts)
    assert fake_kernels.launches[name] == before[name] + 1
    assert fake_kernels.backward_calls()[name] == calls + 1
    ref_in = [t.detach().clone().requires_grad_(True) for t in inputs]
    rout = plain(*ref_in)
    routs = rout if isinstance(rout, tuple) else (rout,)
    want = torch.autograd.grad(routs, ref_in, gouts)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert err == 0.0, err


# The MLP's bf16 backward against the float32 plain route's gradients.
# On the path to each gradient lie at most four bf16 roundings, each within
# 2^-9 of its value: hb; ab, or dg and du; the product's other operand
# derived from them (dh's dg and du); the gradient's cast to bf16.  Their
# sum, 4 x 2^-9 = 7.8e-3 of each gradient's Frobenius norm, holds where a
# product's terms do not cancel; random operands cancel about as much as
# their rounding errors do, so the bound stands as is.  (The plain route in
# bf16 reads 1.7e-3, its one cast; this route 3.0-3.5e-3 at the CPU shapes.)
MLP_TC_BWD_REL = 4 * 2.0 ** -9


def _mlp_inputs(gen, T, d, f, dtype):
    return tuple(t.to(dtype) for t in (
        torch.randn(T, d, generator=gen),
        1 + 0.1 * torch.randn(d, generator=gen),
        torch.randn(d, f, generator=gen) * d ** -0.5,
        torch.randn(d, f, generator=gen) * d ** -0.5,
        torch.randn(f, d, generator=gen) * f ** -0.5))


def _rel_frobenius(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def test_swiglu_backward_plain_is_autograd_in_float64():
    """``swiglu_backward_ref`` in float64 is ``silu(g) * u`` and its
    autograd for g and u, bit for bit; the wrapper on float32 CPU tensors
    runs it and rounds each to bf16, within one bf16 step of those."""
    gen = torch.Generator().manual_seed(7)
    g = (4 * _rand(gen, 37, 53)).requires_grad_(True)
    u = _rand(gen, 37, 53).requires_grad_(True)
    da = _rand(gen, 37, 53)
    a = torch.nn.functional.silu(g) * u
    dg, du = torch.autograd.grad(a, (g, u), da)
    got = R.swiglu_backward_ref(g.detach(), u.detach(), da)
    assert all(torch.equal(x, y) for x, y in zip(got, (a.detach(), dg, du)))
    got = MB.swiglu_backward(g.detach().float(), u.detach().float(),
                             da.float())
    for x, y in zip(got, (a.detach(), dg, du)):
        assert x.dtype == torch.bfloat16
        assert bool(((x.double() - y).abs() <= 2.0 ** -7 * y.abs()).all())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_mlp_backward_route_follows_the_type(dtype, fake_kernels):
    """bf16 inputs take the tensor-core backward (``tc_backward_calls``
    and ``backward_calls`` one more each); float32 and float64 the plain
    recompute (``tc_backward_calls`` unchanged), whose gradients are the
    plain route's bit for bit.  The forward launches once either way."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    ins = [t.requires_grad_(True) for t in _mlp_inputs(gen, 9, 16, 24, dt)]
    y = AG.FusedMlpFn.apply(*ins, 1e-6)
    gy = torch.randn(y.shape, generator=gen).to(dt)
    got = torch.autograd.grad(y, ins, gy)
    tc = dtype == "bfloat16"
    assert fake_kernels.launches["fused_mlp"] == 1
    assert fake_kernels.mlp.backward_calls == 1
    assert fake_kernels.mlp.tc_backward_calls == int(tc)
    assert all(a.dtype == dt for a in got)
    refs = [t.detach().clone().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(R.fused_mlp_ref(*refs, eps=1e-6), refs, gy)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    assert same if not tc else not same


@pytest.mark.parametrize("T,d,f", [(64, 128, 256), (33, 24, 40)])
def test_mlp_tc_backward_matches_the_float32_plain_route(T, d, f,
                                                         fake_kernels):
    """The bf16 backward (hb, ab, dg and du rounded to bf16, the products'
    sums in float32) against the float32 plain route's autograd on the
    same bf16 values: each gradient within MLP_TC_BWD_REL relative
    Frobenius.  Asked for some gradients only, it computes those, equal
    to the full call's."""
    gen = torch.Generator().manual_seed(9)
    ins = _mlp_inputs(gen, T, d, f, torch.bfloat16)
    gy = torch.randn(T, d, generator=gen).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(AG.FusedMlpFn.apply(*leaves, 1e-6), leaves, gy)
    refs = [t.float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(R.fused_mlp_ref(*refs, eps=1e-6), refs,
                               gy.float())
    errs = [_rel_frobenius(a, b) for a, b in zip(got, want)]
    assert max(errs) <= MLP_TC_BWD_REL, errs
    some = MB.fused_mlp_backward(*ins, gy, 1e-6,
                                 (False, False, True, False, True))
    assert [t is None for t in some] == [True, True, False, True, False]
    assert torch.equal(some[2], got[2]) and torch.equal(some[4], got[4])


@pytest.mark.parametrize("T,d,f", [(64, 128, 256), (33, 24, 40)])
def test_mlp_tc_backward_matches_jax_grad_in_bf16(T, d, f, fake_kernels):
    """The bf16 backward against ``jax.grad`` of the JAX package's
    ``fused_mlp_ref`` on the same bf16 x, weights and dy.  That reference
    trains in bf16 too: it rounds the normalised h to bf16 as ``hb`` is
    rounded here, keeps g, u, a, dg and du in float32 and rounds dh to
    bf16 instead.  Each of the five gradients within MLP_TC_BWD_REL
    relative Frobenius."""
    _needs_jax()
    gen = torch.Generator().manual_seed(12)
    ins = _mlp_inputs(gen, T, d, f, torch.bfloat16)
    gy = torch.randn(T, d, generator=gen).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(AG.FusedMlpFn.apply(*leaves, 1e-6), leaves, gy)
    assert fake_kernels.mlp.tc_backward_calls == 1

    def jnp_bf16(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jy = jnp_bf16(gy).astype(jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(JR.fused_mlp_ref(*a, eps=1e-6)
                                       .astype(jnp.float32) * jy),
                    argnums=tuple(range(5)))(*map(jnp_bf16, ins))
    errs = []
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        errs.append(_rel_frobenius(a, torch.from_numpy(
            np.array(b.astype(jnp.float32)))))
    print(f"T={T} d={d} f={f}: rel Frobenius vs jax.grad {errs}")
    assert max(errs) <= MLP_TC_BWD_REL, errs


def test_ops_take_the_functions_only_for_training(fake_kernels):
    """Grad mode on and an input that requires a gradient: the Function
    (an output with a grad_fn, a plain backward counted).  Under
    ``no_grad`` or with no input requiring one, the kernel is called as
    in serving: an output without a grad_fn, no Function."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, generator=gen)
    w = [torch.ones(8), torch.randn(8, 16, generator=gen),
         torch.randn(8, 16, generator=gen), torch.randn(16, 8, generator=gen)]
    y = ops.mlp(x, *w)
    assert y.grad_fn is None and fake_kernels.launches["fused_mlp"] == 1
    wg = w[1].clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.mlp(x, w[0], wg, *w[2:]).grad_fn is None
    y = ops.mlp(x, w[0], wg, *w[2:])
    assert "FusedMlpFnBackward" in _graph(y)
    y.sum().backward()
    assert wg.grad is not None
    assert fake_kernels.launches["fused_mlp"] == 3
    assert fake_kernels.backward_calls()["fused_mlp"] == 1
    ref = ops.mlp(x, w[0], wg, *w[2:], impl="ref")
    assert ref.grad_fn is not None and "FusedMlpFnBackward" not in _graph(ref)


def test_serving_after_a_train_step_bypasses_the_functions(fake_kernels):
    """A train step leaves the state's parameters with ``requires_grad``
    False, so serving them afterwards (grad mode on, as the batcher and
    ``launch/serve.py`` run) calls the kernels as before: prefill and
    decode outputs and the cache without a grad_fn, no plain backward,
    one launch a layer."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    params = TM.init(cfg, 0, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    state, _ = tsteps.make_train_step(cfg, TAdamW())(
        state, _torch(_batch(cfg)))
    assert fake_kernels.backward_calls()["fused_mlp"] == cfg.n_layers
    assert not any(p.requires_grad for p in tree_leaves(state["params"]))
    before = dict(fake_kernels.launches)
    cache = TM.init_cache(cfg, B, 2 * S, dtype=TM.torch_dtype(cfg.dtype),
                          device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    logits, cache = TM.prefill(state["params"], cfg, tokens, cache)
    step, cache = TM.decode_step(state["params"], cfg, tokens[:, -1], cache)
    assert logits.grad_fn is None and step.grad_fn is None
    assert not any(t.requires_grad for t in tree_leaves(cache))
    assert fake_kernels.backward_calls()["fused_mlp"] == cfg.n_layers
    assert fake_kernels.launches["fused_mlp"] - before["fused_mlp"] == \
        2 * cfg.n_layers
    assert fake_kernels.launches["flash_attention"] - \
        before["flash_attention"] == cfg.n_layers


def _graph(t) -> set[str]:
    """The names of the autograd nodes behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [n for n, _ in node.next_functions]
    return {type(n).__name__ for n in seen}


@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_1p2b",
                                  "whisper_base"])
def test_kernel_route_gradients_reach_every_leaf(arch, fake_kernels,
                                                 monkeypatch):
    """Through the Functions every parameter leaf gets the plain route's
    gradient (bit for bit: the same plain versions), and each kernel
    launches once a layer in the forward and once more in remat's
    recompute, with one plain backward a layer.  Without the Functions
    (the kernels' outputs without a grad_fn, as the ctypes wrappers give
    them) the weights behind the kernels get none: the silent failure
    the Functions prevent."""
    cfg = tconfigs.get_smoke(arch)
    assert cfg.remat == "dots"
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    tk, _, gk = _grads(params, cfg, batch)
    tr, _, gr = _grads(params, dataclasses.replace(cfg, attn_impl="ref"),
                       batch)
    assert float(tk) == float(tr)
    assert all(g is not None for g in gk.values())
    assert all(torch.equal(gk[k], gr[k]) for k in gk)
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.attn_every
        per = {"ssd_scan": cfg.n_layers, "flash_attention": sites,
               "fused_mlp": sites}
    elif cfg.family == "encdec":     # encoder, decoder, cross-attention
        per = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
               "fused_mlp": cfg.n_enc_layers + cfg.n_layers}
    else:
        per = {"flash_attention": cfg.n_layers, "fused_mlp": cfg.n_layers}
    assert {k: v for k, v in fake_kernels.launches.items() if v} == \
        {k: 2 * v for k, v in per.items()}
    assert {k: v for k, v in fake_kernels.backward_calls().items() if v} \
        == per
    monkeypatch.setattr(AG, "needs_grad", lambda *t: False)
    detached = {n: _detached(fn) for n, fn in
                (("_flash_kernel", ops._flash_kernel),
                 ("_mlp_kernel", ops._mlp_kernel),
                 ("_ssd_kernel", ops._ssd_kernel))}
    for n, fn in detached.items():
        monkeypatch.setattr(ops, n, fn)
    _, _, gn = _grads(params, cfg, batch)
    missing = sorted(k for k, g in gn.items() if g is None)
    assert any(k.endswith("mlp.wg") for k in missing), missing


def _detached(fn):
    def call(*a, **kw):
        out = fn(*a, **kw)
        return (tuple(o.detach() for o in out) if isinstance(out, tuple)
                else out.detach())
    return call


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_1p2b",
                                  "granite_moe_3b_a800m"])
def test_remat_settings_agree(arch):
    """"none", "full" and "dots" give equal losses and gradients (the
    same operations, recomputed or saved)."""
    base = tconfigs.get_smoke(arch)
    params = TM.init(base, 0, device="cpu")
    batch = _torch(_batch(base))
    out = {r: _grads(params, dataclasses.replace(base, remat=r), batch)
           for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert float(out[r][0]) == float(out["none"][0])
        err = max(float((out[r][2][k] - g).abs().max())
                  for k, g in out["none"][2].items())
        assert err <= 1e-6, (r, err)
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(params, dataclasses.replace(base, remat="some"), batch)


def test_moe_replay_survives_the_recompute():
    """``expert_choices`` under a checkpoint's recompute: each layer
    records its choices once, and a replay (here of other experts than
    the router's) stays aligned: under "dots" the router's records, the
    loss and the gradients equal those under "none" on the same replayed
    experts, and differ from the unforced run's."""
    base = tconfigs.get_smoke("granite_moe_3b_a800m")
    params = TM.init(base, 0, device="cpu")
    batch = _torch(_batch(base))
    with TL.expert_choices() as own:
        _grads(params, dataclasses.replace(base, remat="none"), batch)
    forced = [(t + 1) % base.n_experts for t in own.chosen]
    runs = {}
    for r in ("none", "dots"):
        with TL.expert_choices(replay=forced) as rec:
            runs[r] = _grads(params, dataclasses.replace(base, remat=r),
                             batch)
        assert len(rec.chosen) == base.n_layers
        runs[r] += (rec.chosen,)
    assert all(torch.equal(a, b)
               for a, b in zip(runs["dots"][3], runs["none"][3]))
    assert float(runs["dots"][0]) == float(runs["none"][0])
    err = max(float((runs["dots"][2][k] - g).abs().max())
              for k, g in runs["none"][2].items())
    assert err <= 1e-6, err
    unforced, _, _ = _grads(params, base, batch)
    assert float(unforced) != float(runs["dots"][0])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["flash_attention", "fused_mlp",
                                   "ssd_scan"])
def test_function_on_card_matches_plain_route(which, dtype):
    """Each Function on the card: the kernel forward and its backward
    (the plain recompute; the MLP's tensor-core backward in bf16)
    against the plain route's autograd on the same inputs.  float32
    within 1e-4 of max|plain| (the kernels' sums in another order), bf16
    within 3e-2 (the forward's, and the MLP backward's, bf16
    roundings)."""
    _needs_card()
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    gen = torch.Generator().manual_seed(5)
    fn_cases = {c[0]: c for c in _function_cases(gen)}
    big = {"flash_attention": lambda: (
        _rand(gen, 2, 8, 100, 64), _rand(gen, 2, 2, 100, 64),
        _rand(gen, 2, 2, 100, 64), torch.zeros(2, 100, dtype=torch.float64)),
        "fused_mlp": lambda: (
            _rand(gen, 40, 64), 1 + 0.1 * _rand(gen, 64),
            _rand(gen, 64, 128, scale=0.125), _rand(gen, 64, 128, scale=0.125),
            _rand(gen, 128, 64, scale=128 ** -0.5)),
        "ssd_scan": lambda: (
            _rand(gen, 2, 100, 4, 16),
            torch.rand(2, 100, 4, generator=gen, dtype=torch.float64) * 0.2
            + 0.01,
            -(torch.rand(4, generator=gen, dtype=torch.float64) + 0.5),
            _rand(gen, 2, 100, 1, 16), _rand(gen, 2, 100, 1, 16),
            _rand(gen, 2, 4, 16, 16))}
    _, _, _, fn, plain = fn_cases[which]
    if which == "ssd_scan":
        fn = lambda x, dt_, A, B_, C, i0: AG.SsdScanFn.apply(  # noqa: E731
            x, dt_, A, B_, C, 32, i0)
        plain = lambda x, dt_, A, B_, C, i0: R.ssd_ref(  # noqa: E731
            x, dt_, A, B_, C, chunk=32, init_state=i0)
    inputs = []
    for i, t in enumerate(big[which]()):
        keep32 = which == "ssd_scan" and i in (1, 2, 5)
        inputs.append(t.to("cuda", torch.float32 if keep32 or
                           (which == "flash_attention" and i == 3) else dt))
    outs = {}
    for label, f in (("kernel", fn), ("plain", plain)):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        out = f(*ins)
        y = out[0] if isinstance(out, tuple) else out
        g = torch.autograd.grad(y.float().square().sum(), ins,
                                allow_unused=True)
        outs[label] = (y, g)
    y, g = outs["kernel"]
    yr, gr = outs["plain"]
    assert float((y.float() - yr.float()).abs().max()) <= \
        tol * float(yr.float().abs().max())
    for a, b in zip(g, gr):
        if b is None:
            continue
        assert a is not None and bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= \
            tol * float(b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((4096, 8192), 0), ((33, 77), 0),
                                          ((3,), 0), ((64, 100), 1)])
def test_swiglu_backward_kernel_matches_plain_on_card(shape, offset):
    """``csrc/fused_mlp_backward.cu`` against its plain version on the
    same float32 inputs: granite's training shape, a ragged count (the
    scalar tail), fewer than four elements, and inputs one element off
    the 16-byte alignment (the scalar instance throughout).  Each bf16
    output within one bf16 step of the plain version's float32 value:
    half a step is the kernel's rounding; expf may differ from the plain
    exp in the last bit, and PyTorch's build contracts ``1 + g * (1 -
    s)`` into an FMA where the kernel (``-fmad=false``) does not.  Where
    that factor cancels
    to near 0, dg also gets 2^-20 of its terms' size, ``|da u| (1 +
    |g|)``, 16 float32 roundings of them.  One launch a call."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(10)
    n = int(np.prod(shape))

    def make(scale):
        buf = torch.randn(n + offset, device="cuda", generator=gen) * scale
        return buf[offset:].view(shape)

    g, u, da = make(4.0), make(1.0), make(1.0)
    before = MB.swiglu_backward.launches
    got = MB.swiglu_backward(g, u, da)
    torch.cuda.synchronize()
    assert MB.swiglu_backward.launches == before + 1
    want = R.swiglu_backward_ref(g, u, da)
    slack = (0.0, 2.0 ** -20 * (da * u).abs() * (1 + g.abs()), 0.0)
    for a, b, extra in zip(got, want, slack):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        af, bf = a.float(), b.float()
        assert bool(((af - bf).abs() <= 2.0 ** -7 * bf.abs() + extra).all())


@pytest.mark.gpu
def test_mlp_tc_backward_on_card_at_granite_width():
    """The MLP's bf16 backward on the card at granite's width (d 2048,
    f 8192, T 512): each gradient within MLP_TC_BWD_REL relative
    Frobenius of the float32 plain route's on the same bf16 values; one
    forward launch, one backward on the tensor-core route, one SwiGLU
    kernel launch."""
    _needs_card()
    from repro_torch.kernels.fused_mlp import fused_mlp
    gen = torch.Generator().manual_seed(11)
    ins = [t.cuda() for t in _mlp_inputs(gen, 512, 2048, 8192,
                                         torch.bfloat16)]
    gy = torch.randn(512, 2048, generator=gen).to("cuda", torch.bfloat16)
    counts = (fused_mlp.launches, fused_mlp.backward_calls,
              fused_mlp.tc_backward_calls, MB.swiglu_backward.launches)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(AG.FusedMlpFn.apply(*leaves, 1e-6), leaves, gy)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.backward_calls,
            fused_mlp.tc_backward_calls, MB.swiglu_backward.launches) == \
        tuple(c + 1 for c in counts)
    refs = [t.float().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(R.fused_mlp_ref(*refs, eps=1e-6), refs,
                               gy.float())
    errs = [_rel_frobenius(a, b) for a, b in zip(got, want)]
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert max(errs) <= MLP_TC_BWD_REL, errs


@pytest.mark.gpu
def test_expert_matmul_backward_on_card():
    """The MoE expert products on the card (``torch.bmm`` with a float32
    ``out_dtype`` has no derivative): ``_ExpertMatmul``'s gradients equal
    the autograd of the same product with the operands upcast (the CPU
    route), within float32 summation order."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.randn(3, 20, 16, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.randn(3, 16, 24, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_(True)
    y = TL._expert_matmul(a, w)
    assert y.dtype == torch.float32 and "_ExpertMatmulBackward" in _graph(y)
    g = torch.randn(y.shape, device="cuda", generator=gen)
    got = torch.autograd.grad(y, (a, w), g)
    a2, w2 = (t.detach().clone().requires_grad_(True) for t in (a, w))
    y2 = torch.bmm(a2.float(), w2.float())
    want = torch.autograd.grad(y2, (a2, w2), g)
    assert float((y - y2).abs().max()) <= 1e-5 * float(y2.abs().max())
    for x, r in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert float((x.float() - r.float()).abs().max()) <= \
            2.0 ** -7 * float(r.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_card(arch):
    """A full ``make_train_step`` at smoke size on the card, 2 steps,
    kernel route against impl="ref" from the same state: losses within
    1e-4 relative (float32 smoke configs), every leaf's gradient reached
    (finite state), the step counter."""
    _needs_card()
    cfg = tconfigs.get_smoke(arch)
    params = TM.init(cfg, 0, device="cuda")
    losses = {}
    for impl in ("auto", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        p = tree_map(lambda t: t.clone(), params)
        state = {"params": p, "opt": adamw_init(p)}
        step = tsteps.make_train_step(c, TAdamW(warmup_steps=1))
        out = []
        for s in range(2):
            state, met = step(state, _torch(_batch(cfg, seed=s), "cuda"))
            out.append(float(met["loss"]))
        assert int(state["opt"]["step"]) == 2
        assert all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(state["params"]))
        losses[impl] = out
    for a, b in zip(losses["auto"], losses["ref"]):
        assert abs(a - b) <= 1e-4 * abs(b), losses
