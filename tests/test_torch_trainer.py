"""The port's optimizer, data, checkpoints, trainer and launcher against
the JAX package's, on the CPU.

- ``lr_schedule`` at warm-up, peak, mid-decay and floor within 1e-7
  relative; ``adamw_apply`` on the same gradients within 1e-6 x max|ref|
  per leaf (one float32 rounding of each product's order); the int8
  payload of ``compress`` / ``ef_roundtrip`` equal exactly.
- ``SyntheticLM`` / ``MemmapLM`` batches bit-equal, for several steps
  and host slices.
- Checkpoints in the reference's format: written by either package and
  restored by the other bit for bit (bf16 included); a corrupted leaf
  raises; retention keeps k; no ``.tmp-`` directory survives.
- ``Trainer`` on the ``tiny`` preset (``examples/train_lm_torch.py``):
  the loss falls; SIGTERM mid-run gives a blocking save and a resumed
  run repeats an uninterrupted run's losses exactly; started from a
  state that the reference's ``Trainer`` saved at step 0, its losses
  match the reference's within 1e-5.
- ``launch/train.py`` on the CPU, and what it refuses.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import checkpointer as TC  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.parallel.sharding import make_mesh  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TCmp  # noqa: E402
from repro_torch.runtime import fault as TF  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

try:                                 # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.checkpoint import checkpointer as JC
    from repro.data import pipeline as JD
    from repro.models import model as JM
    from repro.models.config import ModelConfig as JConfig
    from repro.optim import adamw as JA
    from repro.optim import compression as JCmp
    from repro.runtime import fault as JF
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
except ImportError:
    jax = None

CPU = torch.device("cpu")
#: examples/train_lm.py's tiny preset
TINY = dict(name="tiny-llama", family="dense", n_layers=4, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=2048,
            dtype="float32", remat="none")


def _needs_jax():
    if jax is None:
        pytest.skip("needs JAX and the repro package")


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ----------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    _needs_jax()
    kw = dict(lr_peak=3e-4, lr_min=3e-5, warmup_steps=100,
              decay_steps=10_000)
    tcfg, jcfg = TA.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    for step in (0, 1, 50, 99, 100, 101, 5050, 7777, 9999, 10_000, 12_000):
        got = float(TA.lr_schedule(tcfg, torch.tensor(step,
                                                      dtype=torch.int32)))
        want = float(JA.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-7 * abs(want), (step, got, want)


def _tree(rng, dtype):
    """A small parameter-like tree (nested dicts, two dtypes)."""
    return {"b": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                  "n": rng.standard_normal((7,)).astype(np.float32)},
            "a": rng.standard_normal((3, 4)).astype(np.float32)}, dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_apply_matches_jax(dtype):
    """Two steps on the same gradients (one clipped, one not): params,
    master, m, v, lr and the global norm."""
    _needs_jax()
    rng = np.random.default_rng(0)
    p_np, _ = _tree(rng, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)),
                      p_np)
    tp = TA.tree_map(lambda t: t, {k: v for k, v in _to_torch(jp).items()})
    jstate = JA.adamw_init(jp)
    tstate = TA.adamw_init(tp)
    kw = dict(lr_peak=1e-2, warmup_steps=1, decay_steps=10, clip_norm=1.0)
    for scale in (10.0, 0.01):               # clipped, then not
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                            .astype(np.float32) * scale, p_np)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.dtype(dtype)),
                          g_np)
        tg = _to_torch(jg)
        jp, jstate, jm = JA.adamw_apply(JA.AdamWConfig(**kw), jp, jg, jstate)
        tp, tstate, tm = TA.adamw_apply(TA.AdamWConfig(**kw), tp, tg, tstate)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for name, jt, tt in (("params", jp, tp), ("master", jstate["master"],
                                                  tstate["master"]),
                             ("m", jstate["m"], tstate["m"]),
                             ("v", jstate["v"], tstate["v"])):
            for a, b in zip(jax.tree.leaves(jt), TA.tree_leaves(tt)):
                want = _np(a)
                got = b.float().numpy()
                assert b.dtype == (torch.bfloat16 if name == "params" and
                                   dtype == "bfloat16" else torch.float32)
                # bf16 params: the same float32 master rounded once
                tol = (2.0 ** -8 if name == "params" and dtype == "bfloat16"
                       else 1e-6)
                assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert int(tstate["step"]) == 2
    norm = TA.global_norm(tg)
    assert abs(float(norm) - float(JA.global_norm(jg))) <= 1e-6 * float(norm)
    clipped, n2 = TA.clip_by_global_norm(tg, 0.5)
    jclipped, _ = JA.clip_by_global_norm(jg, 0.5)
    for a, b in zip(jax.tree.leaves(jclipped), TA.tree_leaves(clipped)):
        assert np.abs(b.numpy() - _np(a)).max() <= 1e-6 * np.abs(_np(a)).max()


def _to_torch(tree):
    """A JAX tree as torch tensors, bf16 kept (through its bits)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_payload_matches_jax(dtype):
    """``compress`` on the same inputs: the int8 payload equal exactly
    (round half to even, as ``jnp.round``), the scale, the new error and
    ``ef_roundtrip``'s gradients within one float32 rounding; values
    placed exactly on halves of the quantum round to even."""
    _needs_jax()
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    g[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]      # scale 1: halves
    err = rng.standard_normal(g.shape).astype(np.float32) * 1e-3
    err[0, :6] = 0.0
    jg = jnp.asarray(g).astype(jnp.dtype(dtype))
    tg = _to_torch(jg)
    q, s, ne = TCmp.compress(tg, torch.from_numpy(err))
    jq, js, jne = JCmp.compress(jg, jnp.asarray(err))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= 1e-7 * float(js)
    assert np.abs(ne.numpy() - np.asarray(jne)).max() <= 1e-6 * float(js)
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    tree_t = {"x": tg, "y": tg[:10]}
    tree_j = {"x": jg, "y": jg[:10]}
    errs_t = TCmp.ef_init(tree_t)
    errs_j = JCmp.ef_init(tree_j)
    for _ in range(2):
        out_t, errs_t = TCmp.ef_roundtrip(tree_t, errs_t)
        out_j, errs_j = JCmp.ef_roundtrip(tree_j, errs_j)
        for k in tree_t:
            assert out_t[k].dtype == tree_t[k].dtype
            want = _np(out_j[k])
            assert np.abs(out_t[k].float().numpy() - want).max() <= \
                1e-6 * np.abs(want).max()
            assert np.abs(errs_t[k].numpy() - np.asarray(errs_j[k])).max() \
                <= 1e-6 * np.abs(want).max()


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def test_data_pipelines_match_jax(tmp_path):
    _needs_jax()
    for lo, hi in ((0, None), (0, 3), (3, 8)):
        kw = dict(vocab_size=1000, seq_len=17, global_batch=8, seed=4,
                  host_lo=lo, host_hi=hi)
        t, j = TD.SyntheticLM(**kw), JD.SyntheticLM(**kw)
        for step in (0, 1, 2, 7):
            bt, bj = t.batch(step), j.batch(step)
            assert set(bt) == set(bj) == {"tokens", "labels"}
            for k in bt:
                assert bt[k].dtype == bj[k].dtype == np.int32
                assert np.array_equal(bt[k], bj[k])
        assert t.state() == j.state()
    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(0).integers(0, 60_000, 5_000).astype(
        np.uint16).tofile(path)
    for lo, hi in ((0, None), (2, 6)):
        kw = dict(path=path, vocab_size=50_000, seq_len=31, global_batch=6,
                  seed=2, host_lo=lo, host_hi=hi)
        t, j = TD.make_pipeline("memmap", **kw), JD.make_pipeline("memmap",
                                                                  **kw)
        for step in range(4):
            bt, bj = t.batch(step), j.batch(step)
            assert all(np.array_equal(bt[k], bj[k]) for k in bj)
    with pytest.raises(KeyError):
        TD.make_pipeline("parquet")


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def _state_pair():
    """A reference train state (bf16 params, float32 optimizer state,
    int32 step) and the same as the port's."""
    cfg = dataclasses.replace(jconfigs.get_smoke("granite_3_2b"),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke("granite_3_2b"),
                               dtype="bfloat16")
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    opt = JA.adamw_init(jp)
    opt = {**opt, "m": jax.tree.map(lambda a: a + 0.25, opt["m"]),
           "step": jnp.asarray(7, jnp.int32)}
    js = {"params": jp, "opt": opt}
    return js, TM.from_jax_train_state(tcfg, jax.tree.map(np.asarray, js),
                                       CPU), tcfg


def _bits(tree) -> dict:
    """Every leaf's raw bytes by dotted name."""
    return {k: (np.asarray(v).tobytes() if not isinstance(v, torch.Tensor)
                else (v.view(torch.int16) if v.dtype == torch.bfloat16
                      else v).numpy().tobytes())
            for k, v in TC._flatten(tree).items()}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port save restores in JAX bit for bit (bf16 as its bits, the
    int32 step), and a JAX save restores in the port; both write the
    same files, manifest keys, dtypes and crc32s."""
    _needs_jax()
    js, ts, tcfg = _state_pair()
    TC.save_pytree(ts, str(tmp_path / "port"), 7)
    JC.save_pytree(js, str(tmp_path / "jax"), 7)
    got_j = JC.restore_pytree(js, str(tmp_path / "port"))
    assert _bits(jax.tree.map(np.asarray, got_j)) == \
        _bits(jax.tree.map(np.asarray, js))
    like = {"params": ts["params"], "opt": ts["opt"]}
    got_t = TC.restore_pytree(like, str(tmp_path / "jax"), device=CPU)
    assert _bits(got_t) == _bits(ts)
    assert got_t["params"]["embed"].dtype == torch.bfloat16
    assert got_t["opt"]["step"].dtype == torch.int32
    # into meta tensors of the state's shapes and types (no allocation)
    from repro_torch.runtime.steps import abstract_train_state
    got_m = TC.restore_pytree(abstract_train_state(tcfg),
                              str(tmp_path / "jax"))
    assert _bits(got_m) == _bits(ts)
    man = {}
    for who in ("port", "jax"):
        with open(tmp_path / who / "step_00000007" / "manifest.json") as f:
            man[who] = json.load(f)
    assert man["port"]["keys"] == man["jax"]["keys"]
    assert man["port"]["treedef"] == man["jax"]["treedef"]
    for k, meta in man["jax"]["leaves"].items():
        mine = man["port"]["leaves"][k]
        assert {f: mine[f] for f in ("file", "shape", "dtype", "crc32")} == \
            {f: meta[f] for f in ("file", "shape", "dtype", "crc32")}


def test_checkpoint_integrity_retention_and_atomicity(tmp_path):
    ts = {"w": torch.randn(4, 5), "h": torch.randn(3).to(torch.bfloat16),
          "step": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path / "ck")
    ck = TC.Checkpointer(d, keep=2)
    saved = {}
    for step in (1, 2, 3, 4):
        ts["w"] += 1.0                      # the copy is taken at save()
        saved[step] = ts["w"].clone()
        ck.save(ts, step)
    ck.wait()
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert not any(".tmp-" in n for n in os.listdir(d))
    assert ck.latest_step() == 4
    got = ck.restore({k: torch.empty_like(v) for k, v in ts.items()})
    assert all(torch.equal(got[k], ts[k]) for k in ts)
    got3 = ck.restore({k: torch.empty_like(v) for k, v in ts.items()}, 3)
    assert torch.equal(got3["w"], saved[3])
    arr = np.load(os.path.join(d, "step_00000004", "w.npy"))
    arr[0, 0] += 1.0
    np.save(os.path.join(d, "step_00000004", "w.npy"), arr)
    with pytest.raises(IOError, match="corruption in 'w'"):
        ck.restore({k: torch.empty_like(v) for k, v in ts.items()})
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"other": torch.empty(1)}, 3)
    with pytest.raises(FileNotFoundError):
        TC.restore_pytree(ts, str(tmp_path / "none"))
    assert TC.latest_step(str(tmp_path / "none")) is None


# ----------------------------------------------------------------------
# fault machinery
# ----------------------------------------------------------------------
def test_fault_machinery_matches_jax():
    _needs_jax()
    rng = np.random.default_rng(2)
    mt, mj = TF.StragglerMonitor(n_hosts=6), JF.StragglerMonitor(n_hosts=6)
    for step in range(12):
        t = rng.uniform(0.9, 1.1, 6)
        if step >= 4:
            t[2] *= 2.0                       # host 2 turns slow
        assert mt.observe(t) == mj.observe(t)
    assert mt.observe(t) == [2]
    clock = iter(range(100)).__next__
    ht = TF.HeartbeatRegistry(3, deadline_s=5.0, clock=clock)
    for _ in range(6):
        ht.beat(0)
        ht.beat(1)
    assert ht.dead_hosts() == [2] and ht.survivors() == [0, 1]
    with TF.PreemptionGuard() as g:
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.preempted


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------
class _Preempting:
    """``SyntheticLM`` batches; SIGTERM to this process when step ``at``
    is asked for (a preemption notice arriving mid-run)."""

    def __init__(self, data, at: int):
        self.data, self.at = data, at

    def batch(self, step: int):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.batch(step)


def _tiny_run(tmp_path, name, data, steps, **over):
    cfg = TConfig(**TINY)
    opt = TA.AdamWConfig(lr_peak=3e-3, warmup_steps=3, decay_steps=steps)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=3,
                         ckpt_dir=str(tmp_path / name), log_every=100,
                         device="cpu", **over)
    return Trainer(cfg, opt, tcfg, data)


def test_trainer_learns_and_resumes_after_sigterm(tmp_path):
    data = TD.SyntheticLM(vocab_size=TINY["vocab_size"], seq_len=32,
                          global_batch=4, seed=0)
    ref = _tiny_run(tmp_path, "ref", data, 16)
    full = [h["loss"] for h in ref.run()]
    assert len(full) == 16 and np.mean(full[-4:]) < np.mean(full[:4])
    assert [h["step"] for h in ref.history] == list(range(1, 17))
    assert sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000009", "step_00000012", "step_00000015"]  # every 3, 3 kept
    cut = _tiny_run(tmp_path, "cut", _Preempting(data, 4), 16)
    first = [h["loss"] for h in cut.run()]
    assert len(first) == 5 and cut.step == 5      # the step in flight ends
    assert TC.latest_step(str(tmp_path / "cut")) == 5   # blocking save
    assert first == full[:5]
    again = _tiny_run(tmp_path, "cut", data, 16)
    assert again.step == 5
    rest = [h["loss"] for h in again.run()]
    assert rest == full[5:]                       # exactly
    # a mesh: the state sharded over it, the same losses (within float32
    # summation order: the data shards' gradients are added)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    sharded = Trainer(TConfig(**TINY), TA.AdamWConfig(
        lr_peak=3e-3, warmup_steps=3, decay_steps=16), TrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path / "m"),
        log_every=100, device="cpu"), data, mesh=mesh)
    assert sharded.state["opt"]["m"]["embed"].sharding.mesh is mesh
    got = [h["loss"] for h in sharded.run()]
    assert max(abs(a - b) for a, b in zip(got, full[:3])) <= 1e-5 * full[0]


def test_trainer_resumes_a_jax_trainers_state(tmp_path):
    """The reference's ``Trainer`` saves its fresh state at step 0; the
    port's, started on that directory, restores it and its first three
    losses match the reference's own three steps within 1e-5."""
    _needs_jax()
    jcfg = JConfig(**TINY)
    data_kw = dict(vocab_size=TINY["vocab_size"], seq_len=32,
                   global_batch=4, seed=1)
    kw = dict(lr_peak=3e-3, warmup_steps=2, decay_steps=6)
    d = str(tmp_path / "shared")
    jt = JTrainer(jcfg, JA.AdamWConfig(**kw), JTrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=d, log_every=100),
        JD.SyntheticLM(**data_kw))
    jt.ckpt.save(jt.state, 0, blocking=True)
    tt = Trainer(TConfig(**TINY), TA.AdamWConfig(**kw), TrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=d, log_every=100,
        device="cpu"), TD.SyntheticLM(**data_kw))
    assert tt.step == 0
    got = [h["loss"] for h in tt.run()]
    want = [h["loss"] for h in jt.run()]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_3_2b", "whisper_base"])
def test_launch_train_on_cpu(arch, tmp_path):
    hist = tlaunch.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                         "--seq", "16", "--global-batch", "2",
                         "--ckpt-dir", str(tmp_path / "ck")])
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_launch_train_refuses_what_is_not_ported(tmp_path):
    """``--mesh-data`` trains on a mesh (here the CPU named at every
    position); what the launcher refuses is a config whose bytes on the
    busiest card exceed it, with or without a mesh that repeats one
    card."""
    hist = tlaunch.main(["--device", "cpu", "--mesh-data", "2", "--steps",
                         "2", "--seq", "16", "--global-batch", "4",
                         "--ckpt-dir", str(tmp_path / "ck")])
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    with pytest.raises(ValueError, match="one card"):
        tlaunch.main(["--arch", "qwen3_moe_235b_a22b", "--full",
                      "--device", "cpu"])
    with pytest.raises(ValueError, match="2x2 mesh over 1 device"):
        tlaunch.main(["--arch", "internvl2_26b", "--full", "--device", "cpu",
                      "--mesh-data", "2", "--mesh-model", "2"])
    g = tconfigs.get_config("granite_3_2b")
    assert tlaunch.train_state_bytes(g) == 16 * g.n_params() < 80e9
    # on one card a 2 x 2 mesh holds the state, a gathered copy of the
    # parameters and two data shards' gradients: 20 bytes a parameter,
    # and a little more for the leaves the model axis cannot split
    # (the embedding's 49155 rows, replicated over it)
    on_one = tlaunch.train_bytes_per_card(g, tlaunch.launch_mesh(2, 2, "cpu"))
    assert 20 * g.n_params() < on_one < 21 * g.n_params() < 80e9
