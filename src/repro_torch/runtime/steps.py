"""Step-function builders: train, prefill and decode, and the shardings
of their state (the port of ``repro.runtime.steps``).

A step here is a plain function, as in the reference, whose callers jit
it there: the port's callers capture the decode step as a CUDA graph
(:class:`~repro_torch.runtime.compiled_step.CompiledStep`, in
``launch/serve.py``), and the train step runs eagerly.

With ``mesh=`` a step is sharded, single-controller: every state leaf is
a :class:`~repro_torch.parallel.sharding.ShardedTensor` placed by the
reference's rules (:func:`train_state_shardings`,
:func:`cache_shardings`), so a mesh position holds its share, and the
batch is split over the mesh axes its ``batch`` axis binds to (the data
shards).  The train step gathers the parameters once for each distinct
device, runs forward and backward for each data shard on its device
(the first position of its row), sums the gradients over the data
shards in ascending order and splits them per spec
(:func:`~repro_torch.parallel.collectives.reduce_scatter`, the contract
of ``psum_scatter_grads``), and each position then runs AdamW on its
pieces.  The loss adds the shards' cross-entropy sums and label counts
before dividing, and the MoE load-balance loss is formed from the
router statistics averaged over the shards, so the step computes what
one device computes.  The serving steps gather the parameters and each
data shard's slots of the cache, run the model, and write the cache
back into its pieces.  The ``model`` axis splits memory, not
arithmetic, and activations are not constrained: each lives whole on
its data shard's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.obs.tracer import maybe_span, resolve_tracer
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply, adamw_init,
                                     tree_leaves, tree_map)
from repro_torch.optim.compression import ef_init, ef_roundtrip
from repro_torch.parallel import traffic
from repro_torch.parallel.collectives import reduce_scatter
from repro_torch.parallel.sharding import (SERVE_RULES, TRAIN_RULES, Mesh,
                                           NamedSharding, P, ShardedTensor,
                                           ShardingRules, make_param_shardings,
                                           shard_tree, spec_for_axes)

__all__ = ["make_prefill_step", "make_decode_step", "make_train_step",
           "abstract_train_state", "train_state_shardings",
           "shard_train_state", "batch_specs", "batch_shardings",
           "abstract_cache", "cache_shardings", "data_shards", "TRAIN_RULES",
           "SERVE_RULES"]


def abstract_train_state(cfg: ModelConfig, compress_grads: bool = False
                         ) -> dict:
    """The train state's shapes and types as ``meta`` tensors (nothing
    allocated): the ``like`` tree of a restore."""
    def leaf(d: L.ParamDef, dtype: torch.dtype | None = None):
        own = (torch.float32 if d.init in ("ssm_a", "dt_bias")
               else M.torch_dtype(cfg.dtype))
        return torch.empty(d.shape, dtype=dtype or own, device="meta")

    def tree(d, dtype=None):
        if isinstance(d, L.ParamDef):
            return leaf(d, dtype)
        return {k: tree(v, dtype) for k, v in d.items()}

    defs = M.param_defs(cfg)
    f32 = torch.float32
    state = {"params": tree(defs),
             "opt": {"master": tree(defs, f32), "m": tree(defs, f32),
                     "v": tree(defs, f32),
                     "step": torch.empty((), dtype=torch.int32,
                                         device="meta")}}
    if compress_grads:
        state["ef"] = tree(defs, f32)
    return state




# ----------------------------------------------------------------------
# shardings
# ----------------------------------------------------------------------
def train_state_shardings(cfg: ModelConfig, mesh: Mesh,
                          rules: ShardingRules = TRAIN_RULES,
                          compress_grads: bool = False,
                          notes: list[str] | None = None) -> dict:
    """The train state's :class:`NamedSharding` tree: master, m, v (and
    the error feedback) split as the parameters, the step replicated."""
    p_sh = make_param_shardings(mesh, M.param_axes(cfg), rules,
                                M.param_defs(cfg), notes)
    state_sh = {"params": p_sh,
                "opt": {"master": p_sh, "m": p_sh, "v": p_sh,
                        "step": NamedSharding(mesh, P())}}
    if compress_grads:
        state_sh["ef"] = p_sh
    return state_sh


def shard_train_state(params: dict, shardings: dict,
                      compress_grads: bool = False) -> dict:
    """A fresh sharded train state from whole parameters: the parameters
    split by ``shardings["params"]`` (:func:`train_state_shardings`),
    then AdamW's state (and the error feedback) made piece by piece, so
    no whole float32 copy exists."""
    sharded = shard_tree(params, shardings["params"])
    state = {"params": sharded, "opt": adamw_init(sharded)}
    if compress_grads:
        state["ef"] = ef_init(sharded)
    return state


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors standing for every model input of one shape cell
    (the dry-run contract)."""
    B, S = shape.global_batch, shape.seq_len
    f32 = M.torch_dtype(cfg.dtype)

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        n_extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        out = {"tokens": spec((B, S - n_extra), torch.int32)}
        if shape.kind == "train":
            out["labels"] = spec((B, S - n_extra), torch.int32)
        if cfg.family == "vlm":
            out["extra_embeds"] = spec((B, n_extra, cfg.d_model), f32)
        if cfg.family == "encdec":
            out["enc_embeds"] = spec((B, cfg.n_frontend_tokens, cfg.d_model),
                                     f32)
        return out
    # decode: one new token against a cache of length S
    return {"token": spec((B,), torch.int32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                    rules: ShardingRules) -> dict:
    out = {}
    for k, v in batch_specs(cfg, shape).items():
        axes = (("batch",) if v.dim() == 1 else ("batch", "seq")
                if v.dim() == 2 else ("batch", "seq", None))
        out[k] = NamedSharding(mesh, spec_for_axes(mesh, rules, axes,
                                                   tuple(v.shape)))
    return out


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode cache of one shape cell as ``meta`` tensors."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        dtype=M.torch_dtype(cfg.dtype), device="meta")


def _shard_axes(axes: tuple, shape: tuple, mesh: Any) -> tuple:
    """A cache leaf's declared axes (:data:`M.CACHE_AXES`) as the
    reference shards them: a per-layer cache's length over the model
    axis (``seq_model``) where no KV heads take it (the latent cache's,
    and k / v where their heads do not divide it)."""
    if "layers" not in axes or "seq" not in axes:
        return axes
    if "kv_heads" in axes and shape[axes.index("kv_heads")] % \
            mesh.shape.get("model", 1) == 0:
        return axes
    return tuple({"kv_heads": None, "seq": "seq_model"}.get(a, a)
                 for a in axes)


def _paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """("a/b", leaf) in sorted-key order, the reference's path keys."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [kv for k in sorted(tree)
            for kv in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]


def _unflatten(template: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                    rules: ShardingRules = SERVE_RULES) -> dict:
    """KV caches: batch over (pod, data), heads over model (or the length,
    where the KV heads do not divide it); latent caches: the length over
    model; SSM states: batch over (pod, data), the inner dim over model;
    ``index`` replicated."""
    aval = abstract_cache(cfg, shape)
    rules_sm = rules.replace(seq_model="model")
    out = tree_map(lambda v, axes: NamedSharding(mesh, spec_for_axes(
        mesh, rules_sm, _shard_axes(axes, v.shape, mesh), tuple(v.shape))),
        {k: v for k, v in aval.items() if k != "index"}, M.cache_axes(aval))
    return {**out, "index": NamedSharding(mesh, P())}


# ----------------------------------------------------------------------
# the data shards of a sharded step
# ----------------------------------------------------------------------
def data_shards(mesh: Mesh, rules: ShardingRules, B: int
                ) -> list[tuple[slice, torch.device, tuple[int, ...]]]:
    """(rows, device, position) of each data shard: the batch split as
    its ``batch`` axis binds on ``mesh`` (one shard when it does not
    divide), each run on the first position of its row of the mesh."""
    (b,) = spec_for_axes(mesh, rules, ("batch",), (B,))
    names = () if b is None else (b,) if isinstance(b, str) else tuple(b)
    sizes = [mesh.shape[n] for n in names]
    D = math.prod(sizes)
    out = []
    for d in range(D):
        pos = [0] * len(mesh.axis_names)
        for n, i in zip(names, np.unravel_index(d, sizes) if names else ()):
            pos[mesh.axis_names.index(n)] = int(i)
        out.append((slice(d * B // D, (d + 1) * B // D),
                    mesh.devices[tuple(pos)], tuple(pos)))
    return out


def _shard_cfg(cfg: ModelConfig, n_shards: int) -> ModelConfig:
    """The config a data shard runs: MoE dispatch groups (``moe_groups``,
    contiguous runs of the batch's tokens) divided among the shards."""
    if not cfg.moe_groups or n_shards == 1:
        return cfg
    if cfg.moe_groups % n_shards:
        raise ValueError(f"{cfg.name}: {cfg.moe_groups} MoE dispatch groups "
                         f"do not split over {n_shards} data shards")
    return dataclasses.replace(cfg, moe_groups=cfg.moe_groups // n_shards)


def _sharded_leaves(tree: Any, what: str) -> list[ShardedTensor]:
    leaves = tree_leaves(tree)
    if not all(isinstance(t, ShardedTensor) for t in leaves):
        raise TypeError(f"a sharded step takes its {what} as ShardedTensors "
                        f"(parallel.sharding.shard_tree)")
    return leaves


def _gathered(params: dict, shards) -> dict:
    """The whole parameters once for each distinct device of ``shards``
    ((rows, device, position) each).  Every data shard's gather counts as
    traffic (:mod:`~repro_torch.parallel.traffic`), also where its device
    already holds them."""
    leaves = _sharded_leaves(params, "parameters")
    out = {}
    for _, dev, pos in shards:
        if dev not in out:
            out[dev] = _unflatten(params, [t.gather(dev, at=pos)
                                           for t in leaves])
        elif traffic.active():
            for t in leaves:
                traffic.report("all-gather", t.gather_bytes(pos))
    return out


# ----------------------------------------------------------------------
# serving steps
# ----------------------------------------------------------------------
def _plain(x: Any) -> torch.Tensor:
    return x.gather() if isinstance(x, ShardedTensor) else x


def _work_cache(cfg: ModelConfig, cache: dict, rows: slice,
                dev: torch.device, pos: tuple[int, ...],
                index: torch.Tensor) -> dict:
    """A data shard's slots of the sharded cache as one whole cache on
    ``dev`` (mesh position ``pos``), in :func:`M.init_cache`'s layout
    (MLA's two leaves one buffer), each leaf gathered along its declared
    ``batch`` axis."""
    axes = dict(_paths(M.cache_axes(cache)))
    named = [(n, t) for n, t in _paths(cache) if n in axes]
    _sharded_leaves(dict(named), "cache")
    n = rows.stop - rows.start
    lens = [t.shape[axes[k].index("seq")] for k, t in named
            if "layers" in axes[k] and "seq" in axes[k]]
    work = M.init_cache(cfg, n, lens[0] if lens else 1,
                        dtype=named[0][1].dtype, device=dev)
    flat = dict(_paths(work))
    for name, st in named:
        b = axes[name].index("batch")
        if flat[name].shape[b] != n or flat[name].dim() != st.ndim:
            raise ValueError(f"cache leaf {name!r} {tuple(st.shape)} does not "
                             f"fit {cfg.name}'s cache layout")
        st.gather_rows(b, rows.start, rows.stop, flat[name], at=pos)
    work["index"] = (index[rows] if index.dim() == 1 else index).to(dev)
    return work


def _put_back(cache: dict, work: dict, rows: slice,
              pos: tuple[int, ...]) -> None:
    axes = dict(_paths(M.cache_axes(cache)))
    flat = dict(_paths(work))
    for name, st in _paths(cache):
        if name in axes:
            st.scatter_rows(axes[name].index("batch"), rows.start,
                            flat[name], at=pos)


def _sharded_serving(cfg: ModelConfig, mesh: Mesh, rules: ShardingRules,
                     run):
    def step(params, batch, cache):
        B = next(iter(batch.values())).shape[0]
        shards = data_shards(mesh, rules, B)
        scfg = _shard_cfg(cfg, len(shards))
        gathered = _gathered(params, shards)
        index = _plain(cache["index"])
        logits, ends = [], []
        for rows, dev, pos in shards:
            work = _work_cache(cfg, cache, rows, dev, pos, index)
            part = {k: v[rows].to(dev) for k, v in batch.items()}
            out, new = run(gathered[dev], scfg, part, work)
            _put_back(cache, new, rows, pos)
            logits.append(out)
            ends.append(new["index"])
        dev0 = shards[0][1]
        out = torch.cat([x.to(dev0) for x in logits])
        end = (ends[0].to(dev0) if ends[0].dim() == 0
               else torch.cat([e.to(dev0) for e in ends]))
        return out, {**cache, "index": end}

    return step


def make_prefill_step(cfg: ModelConfig, mesh: Mesh | None = None,
                      rules: ShardingRules = SERVE_RULES):
    """step(params, {"tokens": (B, S)}, cache) -> (logits (B, V), cache).
    With ``mesh``: params and cache as ShardedTensors, the logits on the
    first data shard's device."""
    def run(params, cfg, batch, cache):
        return M.prefill(params, cfg, batch["tokens"], cache,
                         enc_embeds=batch.get("enc_embeds"),
                         extra_embeds=batch.get("extra_embeds"))

    if mesh is not None:
        return _sharded_serving(cfg, mesh, rules, run)

    def prefill_step(params, batch, cache):
        return run(params, cfg, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh: Mesh | None = None,
                     rules: ShardingRules = SERVE_RULES):
    """step(params, {"token": (B,)}, cache) -> (logits (B, V), cache).
    With ``mesh`` as :func:`make_prefill_step`."""
    def run(params, cfg, batch, cache):
        return M.decode_step(params, cfg, batch["token"], cache)

    if mesh is not None:
        return _sharded_serving(cfg, mesh, rules, run)

    def decode_step(params, batch, cache):
        return run(params, cfg, batch, cache)

    return decode_step


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def _global_aux(cfg: ModelConfig, stats: list[list], dev) -> torch.Tensor:
    """The MoE load-balance loss of the whole batch from each data
    shard's per-layer (me, ce): the layers' mean of E * sum(me ce), me
    and ce averaged over the shards (equal token counts)."""
    n = len(stats[0])
    if any(len(s) != n for s in stats) or n != cfg.n_layers:
        raise RuntimeError(f"{cfg.name}: MoE statistics of {[len(s) for s in stats]}"
                           f" layers, expected {cfg.n_layers} a shard")
    per_layer = []
    for layer in range(n):
        me = torch.stack([s[layer][0].to(dev) for s in stats]).mean(0)
        ce = torch.stack([s[layer][1].to(dev) for s in stats]).mean(0)
        per_layer.append(cfg.n_experts * torch.sum(me * ce))
    return torch.stack(per_layer).mean()


def _grads(params: dict, cfg: ModelConfig, batch: dict, shards: list,
           tracer=None) -> tuple[torch.Tensor, dict, list[list]]:
    """(total, metrics, each data shard's gradients in :func:`tree_leaves`
    order) of the batch split over ``shards`` ((rows, device, position)
    each;
    ``params`` maps a device to the whole parameters there): one
    backward through every shard's forward.  The shards add their
    cross-entropy sums and label counts before dividing, and with more
    than one the MoE aux is formed from their averaged router
    statistics, so the loss is the whole batch's.  A parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives it.  The gradients
    are taken with respect to detached aliases of the parameters, so the
    caller's tensors keep ``requires_grad`` False and serve as before.
    Spans: ``train.forward`` (the shards' forwards and the loss) and
    ``train.backward`` (the one backward, remat's recompute within)."""
    dev0 = shards[0][1]
    scfg = _shard_cfg(cfg, len(shards))
    trees = [tree_map(lambda p: p.detach().requires_grad_(True),
                      params[dev]) for _, dev, _ in shards]
    leaves = [tree_leaves(t) for t in trees]
    with torch.enable_grad():
        with maybe_span(tracer, "train.forward", cat="train"):
            sums, counts, auxs, stats = [], [], [], []
            with L.moe_stats() as seen:
                for (rows, dev, _), tree in zip(shards, trees):
                    part = {k: v[rows].to(dev) for k, v in batch.items()}
                    n0 = len(seen)
                    ce_sum, count, aux = M.loss_sums(tree, scfg, part)
                    stats.append(seen[n0:])
                    sums.append(ce_sum.to(dev0))
                    counts.append(count.to(dev0))
                    auxs.append(aux.to(dev0))
            count = torch.stack(counts).sum()
            loss = torch.stack(sums).sum() / count.clamp_min(1.0)
            aux = (_global_aux(cfg, stats, dev0)
                   if cfg.n_experts and len(shards) > 1 else auxs[0])
            total = loss + cfg.router_aux_loss * aux
        flat = [p for ls in leaves for p in ls]
        with maybe_span(tracer, "train.backward", cat="train"):
            grads = torch.autograd.grad(total, flat, allow_unused=True)
    n = len(leaves[0])
    per = [[torch.zeros_like(p) if g is None else g
            for p, g in zip(flat[d * n:(d + 1) * n], grads[d * n:(d + 1) * n])]
           for d in range(len(shards))]
    return (total.detach(), {"loss": loss.detach(), "aux": aux.detach(),
                             "tokens": count}, per)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    mesh: Mesh | None = None,
                    rules: ShardingRules = TRAIN_RULES,
                    compress_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), the state
    ``{"params", "opt": {"master", "m", "v", "step"}, "ef"?}`` updated
    IN PLACE (:mod:`repro_torch.optim.adamw`).

    With ``cfg.microbatches`` > 1 the batch is split on its first axis
    the reference's way, the float32 gradients are accumulated ``/ mb``
    and the loss and metrics are the microbatches' means.  Then the
    error-feedback roundtrip (``compress_grads``), then AdamW.  Metrics:
    ``loss``, ``aux``, ``tokens``, ``lr``, ``grad_norm``, ``total_loss``,
    as 0-d tensors.

    With ``mesh`` the state is sharded (:func:`shard_train_state`) and
    the step runs as the module's docstring says; the batch is whole
    tensors on any device, each microbatch split over the data shards.
    Without it the step is the one-shard case of the same loop.

    Spans (the process-global tracer at the call, which is the returned
    function's ``tracer``, and the profiler's ranges): each microbatch's
    ``train.forward`` and ``train.backward``, then ``train.optimizer``
    (the error-feedback roundtrip, AdamW); no span covers the whole step.
    """
    tracer = resolve_tracer(None)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        mb = max(cfg.microbatches, 1)
        B = next(iter(batch.values())).shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches")
        Bm = B // mb
        if mesh is None:
            leaves = tree_leaves(params)
            shards = [(slice(0, Bm), leaves[0].device, None)]
            gathered = {leaves[0].device: params}
        else:
            leaves = _sharded_leaves(params, "train state")
            shards = data_shards(mesh, rules, Bm)
            gathered = _gathered(params, shards)
        per, losses, mets = None, [], []
        for j in range(mb):        # the reference's split: rows j*Bm...
            part = {k: v[j * Bm:(j + 1) * Bm] for k, v in batch.items()}
            loss, met, g = _grads(gathered, cfg, part, shards, tracer)
            losses.append(loss)
            mets.append(met)
            if mb == 1:
                per = g
                continue
            if per is None:
                per = [[torch.zeros(t.shape, dtype=torch.float32,
                                    device=dev) for t in leaves]
                       for _, dev, _ in shards]
            for acc, gd in zip(per, g):
                for a, gi in zip(acc, gd):
                    a.add_(gi.to(torch.float32) / mb)
            del g
        del gathered
        if mesh is None:
            (grads,) = per
        else:
            # the data shards' gradients summed in ascending order, split
            # per spec: each position ends with the slice it owns
            grads = []
            for i, leaf in enumerate(leaves):
                parts = [gd[i] for gd in per]
                for gd in per:
                    gd[i] = None
                grads.append(reduce_scatter(parts, leaf.sharding))
                del parts
        del per
        with maybe_span(tracer, "train.optimizer", cat="train"):
            if compress_grads:
                grads, _ = ef_roundtrip(grads, state["ef"])
            _, _, opt_metrics = adamw_apply(opt_cfg, params, grads,
                                            state["opt"])
        if mb == 1:
            loss, metrics = losses[0], mets[0]
        else:
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        return state, {**metrics, **opt_metrics, "total_loss": loss}

    train_step.tracer = tracer
    return train_step
