"""The sharded train, prefill and decode steps on the CPU: against the
port's own unsharded steps and the JAX package's unsharded jitted step.

The reference's two sharded-step tests fail on every run
(``tests/test_distribution.py``), so the sharded steps are held against
the single-device step, as GSPMD promises: a mesh changes where state
lives, not what is computed.

- Training on a 2 x 4 (data x model) mesh of ``["cpu"] * 8``, granite,
  granite-moe and zamba2 at their smoke sizes in float32, with some
  labels masked (-1), so the loss is a ratio of the shards' summed sums
  and counts: against the port's unsharded step over 2 steps the loss
  within 1e-4 and every parameter within 1e-2 (the reference test's
  bounds), and, tighter, grad_norm within 1e-5 relative, each leaf of m
  and v within 1e-5 x max|ref| and of params and master within 1e-4 x
  max|ref|; also with ``microbatches=4`` and ``compress_grads`` (the
  error feedback nonzero and within 1e-5 of the corrected gradient's
  scale of the unsharded step's, but for at most 0.1 % of its elements,
  each within one int8 quantum; the state and grad_norm (1e-4) under
  the same flip rule); against the reference's ``jax.jit(make_train_step(cfg,
  opt))`` over 3 steps the metrics within 1e-5 and params, master, m and
  v within 1e-4 x max|ref| per leaf but for at most 0.1 % of its
  elements, each within 2 x the steps' lr (``tests/test_torch_train.py``'s
  parity bound and its flip rule).
- Serving on a 2 x 2 mesh: granite, mamba2 and minicpm3 prefill and
  decode, the logits within 1e-5 x max|logits| of the unsharded steps,
  and the cache put back together equal to theirs within the same.
- ``Trainer(mesh=)`` checkpoints on 2 x 4 and resumes on 4 x 2.

Each test reports its max abs error.
"""
from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.config import ShapeConfig as TShape  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig as TAdamW  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_leaves  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.optim import compression as TCmp  # noqa: E402
from repro_torch.optim.compression import ef_init  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.compiled_step import CompiledStep  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_init as j_adamw_init
    from repro.runtime.steps import make_train_step as j_make_train_step
except ImportError:
    jax = None

TRAIN_ARCHS = ("granite_3_2b", "granite_moe_3b_a800m", "zamba2_1p2b")
SERVE_ARCHS = ("granite_3_2b", "mamba2_2p7b", "minicpm3_4b")
CASES = {"plain": ({}, False), "microbatches=4": ({"microbatches": 4}, False),
         "compress_grads": ({}, True)}
OPT = dict(lr_peak=1e-3, warmup_steps=1, decay_steps=10)
# sharded vs unsharded, relative: grad_norm, m and v within 1e-5; params
# and master within 1e-4 (tests/test_torch_train.py's parity bound: an
# element whose gradient is near Adam's eps takes a step anywhere in
# [0, lr], so float32 differences of 1e-7 in it move the step by more)
STATE_REL = 1e-5
PARAM_REL = 1e-4
NORM_REL_COMPRESS = 1e-4   # grad_norm after the int8 roundtrip (flips)


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _mesh(shape, device="cpu"):
    return TS.make_mesh(shape, ("data", "model"),
                        devices=[device] * int(np.prod(shape)))


def _batch(cfg, seed=0, b=8, s=16) -> dict:
    """tokens, labels with some masked (-1), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :7] = -1                  # data shard 0 has fewer labels
    labels[-1, -1] = -1
    return {"tokens": toks, "labels": labels}


def _torch(batch, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unsharded_and_sharded(cfg, compress, mesh, device="cpu"):
    one = {"params": TM.init(cfg, 0, device=device)}
    one["opt"] = adamw_init(one["params"])
    if compress:
        one["ef"] = ef_init(one["params"])
    sh = tsteps.train_state_shardings(cfg, mesh, compress_grads=compress)
    many = tsteps.shard_train_state(TM.init(cfg, 0, device=device), sh,
                                    compress)
    return one, many


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_the_unsharded_step(arch, case,
                                                      monkeypatch):
    over, compress = CASES[case]
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **over)
    mesh = _mesh((2, 4))
    one, many = _unsharded_and_sharded(cfg, compress, mesh)
    step1 = tsteps.make_train_step(cfg, TAdamW(**OPT),
                                   compress_grads=compress)
    step8 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh,
                                   compress_grads=compress)
    loss_err, norm_err, lr_sum, quanta = 0.0, 0.0, 0.0, []
    plain_compress = TCmp.compress

    def recording(g, err, scale=None):    # each leaf's int8 quantum
        out = plain_compress(g, err, scale)
        quanta.append(float(out[1]))
        return out
    for s in range(2):
        batch = _torch(_batch(cfg, seed=s))
        quanta.clear()
        monkeypatch.setattr(TCmp, "compress", recording)
        one, m1 = step1(one, batch)
        monkeypatch.setattr(TCmp, "compress", plain_compress)
        many, m8 = step8(many, batch)
        assert set(m1) == set(m8)
        loss_err = max(loss_err, abs(float(m1["loss"]) - float(m8["loss"])))
        assert abs(float(m1["tokens"]) - float(m8["tokens"])) == 0.0
        assert abs(float(m1["aux"]) - float(m8["aux"])) <= 1e-5
        # the norm of the reduced gradients: a dropped or doubled data
        # shard, or zeros applied, moves it far past this
        rel = abs(float(m1["grad_norm"]) - float(m8["grad_norm"])) / float(
            m1["grad_norm"])
        norm_err = max(norm_err, rel)
        assert rel <= (NORM_REL_COMPRESS if compress else STATE_REL), (s, rel)
        lr_sum += float(m1["lr"])
    assert loss_err < 1e-4, loss_err
    assert int(many["opt"]["step"]) == 2
    got = _flat(TS.gather_tree(many))
    want = _flat(one)
    param_err, state_err = 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        err = float((g.float() - w.float()).abs().max())
        if k.startswith("params."):
            param_err = max(param_err, err)
            assert err < 1e-2, (k, err)
        if not k.startswith(("params.", "opt.master.", "opt.m.", "opt.v.")):
            continue
        # every leaf of the state elementwise, relative to its max: a
        # piece updated from another's gradient or moments shows
        scale = max(float(w.float().abs().max()), 1e-30)
        state_err = max(state_err, err / scale)
        tol = STATE_REL if k.startswith(("opt.m.", "opt.v.")) else PARAM_REL
        if not compress:
            assert err <= tol * scale, (k, err / scale)
            continue
        # tests/test_torch_train.py's flip rule: an element whose scaled
        # gradient lies within rounding of a half takes the other int8
        # payload, one quantum off; at most 0.1 % of a leaf, each within
        # what one quantum moves it
        e = (g.float() - w.float()).abs()
        assert float((e > tol * scale).float().mean()) <= 1e-3, k
        flip = (scale / 127 if k.startswith("opt.m.")
                else 2 * scale / 127 if k.startswith("opt.v.")
                else 2 * lr_sum)
        assert err <= tol * scale + flip, (k, err / scale)
    if compress:
        ef_err = 0.0
        ef_keys = [k for k in want if k.startswith("ef.")]
        assert len(quanta) == len(ef_keys)
        for k, q in zip(ef_keys, quanta):
            g, w = got[k].numpy(), want[k].numpy()
            assert np.abs(w).max() > 0, k              # a nonzero residue
            err = np.abs(g - w)
            ef_err = max(ef_err, float(err.max()))
            # the residue is g + e less the payload: within 1e-5 of the
            # corrected gradient's scale (127 q), except where an element
            # within rounding of a half flips its payload by one quantum
            assert np.mean(err > 1e-5 * 127 * q) <= 1e-3, k
            assert float(err.max()) <= q * (1 + 1e-5) + 1e-5 * 127 * q, k
        print(f"ef max abs err {ef_err:.3e}")
    print(f"{arch} {case}: loss max abs err {loss_err:.3e}, params max abs "
          f"err {param_err:.3e}, grad_norm max rel err {norm_err:.3e}, "
          f"params/master/m/v max err over max|ref| {state_err:.3e}")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_jax(arch):
    """3 steps of the port's sharded step (2 x 4) against the
    reference's unsharded jitted step from the same state, with masked
    labels."""
    _needs_jax()
    cfg = jconfigs.get_smoke(arch)
    tcfg = tconfigs.get_smoke(arch)
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    js = {"params": jp, "opt": j_adamw_init(jp)}
    mesh = _mesh((2, 4))
    ts = TM.from_jax_train_state(tcfg, jax.tree.map(np.asarray, js), "cpu")
    ts = tsteps.shard_train_state(ts["params"], tsteps.train_state_shardings(
        tcfg, mesh))
    jstep = jax.jit(j_make_train_step(cfg, JAdamW(**OPT)))
    tstep = tsteps.make_train_step(tcfg, TAdamW(**OPT), mesh=mesh)
    worst, lr_sum = 0.0, 0.0
    for s in range(3):
        batch = _batch(cfg, seed=10 + s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        lr_sum += float(jm["lr"])
        ts, tm = tstep(ts, _torch(batch))
        assert set(tm) == set(jm)
        for k in jm:
            err = abs(float(tm[k]) - float(jm[k]))
            assert err <= 1e-5 * abs(float(jm[k])) + 1e-7, (s, k, err)
            worst = max(worst, err)
    want = _flat(jax.tree.map(np.asarray, {"params": js["params"],
                                           "opt": js["opt"]}))
    got = _flat(TM.to_numpy(TS.gather_tree({"params": ts["params"],
                                            "opt": ts["opt"]})))
    state_err = 0.0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        scale = np.abs(w).max()
        state_err = max(state_err, float(err.max()))
        # the parity bound's flip rule (tests/test_torch_train.py): an
        # element whose gradient is near 0 takes an Adam step of about
        # lr whichever its sign, and differences of 1e-6 in such a
        # gradient can flip it (granite-moe's router, in the unsharded
        # port's step against the reference too); at most 0.1 % of a
        # leaf, each within 2 x the steps' lr
        assert np.mean(err > 1e-4 * scale) <= 1e-3, k
        assert float(err.max()) <= 1e-4 * scale + 2 * lr_sum, k
    print(f"{arch}: metrics max abs err {worst:.3e}, state max abs err "
          f"{state_err:.3e}")


def test_the_loss_adds_sums_and_counts_over_the_shards():
    """With the labels masked unevenly the per-shard means' mean is not
    the loss: the sharded step's loss is the ratio of the summed sums
    and counts, as the unsharded loss_fn computes it."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    batch["labels"][:4, 1:] = -1        # shard 0: 4 labels, shard 1: 63
    _, met = TM.loss_fn(params, cfg, batch)
    halves = [TM.loss_fn(params, cfg, {k: v[r] for k, v in batch.items()})[1]
              for r in (slice(0, 4), slice(4, 8))]
    mean_of_means = (float(halves[0]["loss"]) + float(halves[1]["loss"])) / 2
    assert abs(mean_of_means - float(met["loss"])) > 1e-3
    mesh = _mesh((2, 4))
    state = tsteps.shard_train_state(params, tsteps.train_state_shardings(
        cfg, mesh))
    _, m8 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)(state,
                                                                  batch)
    assert abs(float(m8["loss"]) - float(met["loss"])) < 1e-5
    assert float(m8["tokens"]) == float(met["tokens"]) == float(
        (batch["labels"] >= 0).sum())


def test_the_moe_aux_is_the_whole_batchs():
    """granite-moe's load-balance loss over the sharded batch equals the
    unsharded one (the router statistics averaged over the shards before
    the product), not the shards' aux averaged."""
    cfg = tconfigs.get_smoke("granite_moe_3b_a800m")
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    _, met = TM.loss_fn(params, cfg, batch)
    halves = [float(TM.loss_fn(params, cfg, {k: v[r] for k, v in
                                             batch.items()})[1]["aux"])
              for r in (slice(0, 4), slice(4, 8))]
    mesh = _mesh((2, 4))
    state = tsteps.shard_train_state(params, tsteps.train_state_shardings(
        cfg, mesh))
    _, m8 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)(state,
                                                                  batch)
    err = abs(float(m8["aux"]) - float(met["aux"]))
    print(f"aux {float(met['aux'])}, sharded {float(m8['aux'])}, shards' "
          f"mean {sum(halves) / 2}")
    assert err < 1e-6
    assert abs(sum(halves) / 2 - float(met["aux"])) > 1e-4


def test_moe_aux_under_full_remat():
    """Under remat "full" a forward records one (me, ce) a MoE layer (the
    step reads them before the backward, whose recompute would add
    more), and the sharded step's aux is the whole batch's."""
    cfg = dataclasses.replace(tconfigs.get_smoke("granite_moe_3b_a800m"),
                              remat="full")
    params = TM.init(cfg, 0, device="cpu")
    batch = _torch(_batch(cfg))
    aliases = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad(), TL.moe_stats() as seen:
        TM.loss_sums(aliases, cfg, batch)
    assert len(seen) == cfg.n_layers, len(seen)
    _, met = TM.loss_fn(params, cfg, batch)
    mesh = _mesh((2, 4))
    state = tsteps.shard_train_state(params, tsteps.train_state_shardings(
        cfg, mesh))
    _, m8 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)(state,
                                                                  batch)
    err = abs(float(m8["aux"]) - float(met["aux"]))
    print(f"aux max abs err {err:.3e}")
    assert err < 1e-6


def test_moe_groups_split_over_thedata_shards():
    cfg = dataclasses.replace(tconfigs.get_smoke("granite_moe_3b_a800m"),
                              moe_groups=4)
    mesh = _mesh((2, 4))
    one, many = _unsharded_and_sharded(cfg, False, mesh)
    batch = _torch(_batch(cfg))
    _, m1 = tsteps.make_train_step(cfg, TAdamW(**OPT))(one, batch)
    _, m8 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)(many,
                                                                  batch)
    assert abs(float(m1["loss"]) - float(m8["loss"])) < 1e-5
    odd = dataclasses.replace(cfg, moe_groups=3)
    _, many = _unsharded_and_sharded(odd, False, mesh)
    with pytest.raises(ValueError, match="do not split"):
        tsteps.make_train_step(odd, TAdamW(**OPT), mesh=mesh)(
            many, _torch(_batch(cfg, b=6)))


def test_train_step_shapes_the_batch_and_state():
    cfg = tconfigs.get_smoke("granite_3_2b")
    mesh = _mesh((2, 4))
    step = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)
    plain = {"params": TM.init(cfg, 0, device="cpu")}
    plain["opt"] = adamw_init(plain["params"])
    with pytest.raises(TypeError, match="ShardedTensor"):
        step(plain, _torch(_batch(cfg)))
    # a batch that does not divide over the data axis runs as one shard
    _, many = _unsharded_and_sharded(cfg, False, mesh)
    _, met = step(many, _torch(_batch(cfg, b=3)))
    assert np.isfinite(float(met["loss"]))
    assert [r for r, *_ in tsteps.data_shards(mesh, TS.TRAIN_RULES, 3)] == \
        [slice(0, 3)]
    assert [r for r, *_ in tsteps.data_shards(mesh, TS.TRAIN_RULES, 8)] == \
        [slice(0, 4), slice(4, 8)]


def test_trainer_checkpoints_on_one_mesh_and_resumes_on_another(tmp_path):
    """A Trainer on 2 x 4 saves every 2 steps; its step-4 checkpoint is
    removed (a run lost after step 4) and a Trainer on 4 x 2 resumes at
    step 2: steps 3-4 within 1e-5 of the first run's losses and of an
    unsharded Trainer's."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                      dtype="float32", remat="none")
    data = TD.SyntheticLM(vocab_size=128, seq_len=16, global_batch=8, seed=0)
    opt = TAdamW(lr_peak=3e-3, warmup_steps=2, decay_steps=4)

    def run(name, mesh):
        return Trainer(cfg, opt, TrainerConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / name),
            log_every=100, device="cpu"), data, mesh=mesh)

    first = run("a", _mesh((2, 4)))
    assert first.state["params"]["embed"].sharding.mesh.shape == {
        "data": 2, "model": 4}
    losses = [h["loss"] for h in first.run()]
    plain = [h["loss"] for h in run("plain", None).run()]
    shutil.rmtree(tmp_path / "a" / "step_00000004")
    again = run("a", _mesh((4, 2)))
    assert again.step == 2
    assert again.state["params"]["embed"].sharding.mesh.shape == {
        "data": 4, "model": 2}
    rest = [h["loss"] for h in again.run()]
    err = max(abs(a - b) for a, b in zip(rest, losses[2:]))
    err_plain = max(abs(a - b) for a, b in zip(losses, plain))
    print(f"resumed losses max abs err {err:.3e}, sharded vs unsharded "
          f"{err_plain:.3e}")
    assert len(rest) == 2 and err <= 1e-5 * max(map(abs, losses))
    assert err_plain <= 1e-5 * max(map(abs, plain))


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _serve_pair(cfg, mesh, B, L, device="cpu"):
    params = TM.init(cfg, 0, device=device)
    one = TM.init_cache(cfg, B, L, dtype=torch.float32, device=device)
    shape = TShape("serve", L, B, "decode")
    many = TS.shard_tree(TM.init_cache(cfg, B, L, dtype=torch.float32,
                                       device=device),
                         tsteps.cache_shardings(cfg, shape, mesh))
    psh = TS.make_param_shardings(mesh, TM.param_axes(cfg), TS.SERVE_RULES,
                                  TM.param_defs(cfg))
    return params, TS.shard_tree(params, psh), one, many


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_match_the_unsharded_steps(arch):
    cfg = tconfigs.get_smoke(arch)
    mesh = _mesh((2, 2))
    B, L = 4, 24
    params, sparams, one, many = _serve_pair(cfg, mesh, B, L)
    toks = torch.randint(0, cfg.vocab_size, (B, 9),
                         generator=torch.Generator().manual_seed(1))
    l1, one = tsteps.make_prefill_step(cfg)(params, {"tokens": toks}, one)
    l4, many = tsteps.make_prefill_step(cfg, mesh=mesh)(
        sparams, {"tokens": toks}, many)
    errs = [float((l1 - l4).abs().max())]
    scale = float(l1.abs().max())
    d1 = tsteps.make_decode_step(cfg)
    d4 = tsteps.make_decode_step(cfg, mesh=mesh)
    tok = l1.argmax(-1)
    for _ in range(4):
        l1, one = d1(params, {"token": tok}, one)
        l4, many = d4(sparams, {"token": tok}, many)
        errs.append(float((l1 - l4).abs().max()))
        tok = l1.argmax(-1)
    assert int(many["index"]) == int(one["index"]) == 13
    cache_err = max(float((a - b.gather()).abs().max())
                    for (ka, a), (kb, b) in zip(_flat(one).items(),
                                                _flat(many).items())
                    if ka != "index")
    print(f"{arch}: logits max abs err {max(errs):.3e} (max|logits| "
          f"{scale:.3f}), cache {cache_err:.3e}")
    assert max(errs) <= 1e-5 * scale
    assert cache_err <= 1e-5


def test_sharded_decode_with_per_slot_lengths():
    """The batcher's cache: a (B,) index, each slot at its own length."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    mesh = _mesh((2, 2))
    params, sparams, one, many = _serve_pair(cfg, mesh, 4, 16)
    lengths = torch.tensor([3, 7, 1, 11], dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    for leaf in tree_leaves(one["attn"]):
        leaf.normal_(generator=gen)
    for (_, a), (_, b) in zip(_flat(one["attn"]).items(),
                              _flat(many["attn"]).items()):
        for pos in mesh.positions():
            b.shards[pos].copy_(a[b.sharding.slices(a.shape, pos)])
    tok = torch.tensor([5, 6, 7, 8])
    l1, c1 = tsteps.make_decode_step(cfg)(params, {"token": tok},
                                          {**one, "index": lengths})
    l4, c4 = tsteps.make_decode_step(cfg, mesh=mesh)(
        sparams, {"token": tok}, {**many, "index": lengths})
    err = float((l1 - l4).abs().max())
    print(f"per-slot decode: logits max abs err {err:.3e}")
    assert err <= 1e-5 * float(l1.abs().max())
    assert torch.equal(c4["index"], lengths + 1)


def test_sharded_decode_runs_in_a_compiled_step():
    """On one device the sharded decode step goes through CompiledStep's
    static buffers (on the card: one graph) and gives the eager step's
    logits."""
    cfg = tconfigs.get_smoke("granite_3_2b")
    mesh = _mesh((2, 2))
    params, sparams, one, many = _serve_pair(cfg, mesh, 4, 16)
    toks = torch.randint(0, cfg.vocab_size, (4, 5),
                         generator=torch.Generator().manual_seed(2))
    decode = tsteps.make_decode_step(cfg, mesh=mesh)
    l4, many = tsteps.make_prefill_step(cfg, mesh=mesh)(
        sparams, {"tokens": toks}, many)
    l1, one = tsteps.make_prefill_step(cfg)(params, {"tokens": toks}, one)

    def fn(token, index):
        out, new = decode(sparams, {"token": token}, {**many, "index": index})
        return out, new["index"]

    step = CompiledStep(fn, device="cpu")
    tok, index = l4.argmax(-1), many["index"]
    for _ in range(3):
        lg, index = step(tok, index)
        ref, one = TM.decode_step(params, cfg, tok, one)
        assert float((lg - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        tok = lg.argmax(-1)
    assert int(index) == 8 and step.steps == 3


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.find_nvcc()
    except build.KernelBuildError as e:
        pytest.skip(str(e))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_on_the_card(arch):
    """The kernel route on a 2 x 2 mesh of the one card against the
    unsharded step, smoke size in float32: loss within 1e-4, params
    within 1e-2."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tconfigs.get_smoke(arch)
    mesh = _mesh((2, 2), "cuda")
    one, many = _unsharded_and_sharded(cfg, False, mesh, "cuda")
    batch = _torch(_batch(cfg), "cuda")
    one, m1 = tsteps.make_train_step(cfg, TAdamW(**OPT))(one, batch)
    many, m4 = tsteps.make_train_step(cfg, TAdamW(**OPT), mesh=mesh)(
        many, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    got = _flat(TS.gather_tree(many["params"]))
    err = max(float((got[k] - w).abs().max())
              for k, w in _flat(one["params"]).items())
    print(f"{arch} on the card: params max abs err {err:.3e}")
    assert err < 1e-2


@pytest.mark.gpu
def test_sharded_decode_is_one_graph_on_the_card():
    """A 2 x 2 mesh of the one card: the sharded decode step captured as
    one CUDA graph gives the eager sharded step's logits bit for bit."""
    _needs_card()
    cfg = dataclasses.replace(tconfigs.get_smoke("granite_3_2b"),
                              dtype="bfloat16")
    mesh = _mesh((2, 2), "cuda")
    _, sparams, _, many = _serve_pair(cfg, mesh, 4, 32, "cuda")
    _, _, _, eager = _serve_pair(cfg, mesh, 4, 32, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (4, 5), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    prefill = tsteps.make_prefill_step(cfg, mesh=mesh)
    decode = tsteps.make_decode_step(cfg, mesh=mesh)
    lg, many = prefill(sparams, {"tokens": toks}, many)
    _, eager = prefill(sparams, {"tokens": toks}, eager)

    def fn(token, index):
        out, new = decode(sparams, {"token": token}, {**many, "index": index})
        return out, new["index"]

    step = CompiledStep(fn, device="cuda")
    tok, index = lg.argmax(-1), many["index"]
    for _ in range(4):
        out, index = step(tok, index)
        ref, eager = decode(sparams, {"token": tok}, eager)
        assert torch.equal(out, ref)
        tok = out.argmax(-1)
    assert step.captures == 1
