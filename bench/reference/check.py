"""The numbers that decide ``correct``, worked out by the reference.

Serving: the program's greedy tokens are judged one by one.  The
reference runs once over each sampled request's prompt and served
tokens; at every served position it reads by how much the served
token's logit lies below its own best logit there, in units of the
standard deviation of its logits at that position (so the number reads
alike at any width or vocabulary).  ``served_gap`` is the widest such
gap over the sample (0 where every served token is the reference's own
first choice).  The control's reading is the same gap of the token that
the reference computed in fp8 puts first.

Training: the reference follows the program's first three steps from
the same weights and batches (:mod:`bench.reference.adamw`).  Compared:
each step's loss (``loss_gap``, relative), each leaf's norm of the first
gradient as the optimizer takes it (``grad_gap``, and the median leaf's
``grad_gap_median``) and of the parameters' change over the three steps
(``change_gap``).  A leaf's gap is the gap between the two norms over
the reference's norm of that leaf or of the median leaf, whichever is
larger; the number is the worst leaf's but where it says median.
Norms average each element's rounding away, so they hardly tell bf16
from fp8: ``grad_diff`` reads the first gradient itself, the norm of
the difference over ``SAMPLE`` elements of each leaf drawn from the
seed, over the reference's norm of the same elements (or the median
leaf's), the worst leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (they move by round-off alone).
"""
from __future__ import annotations

import statistics

import torch

from bench.reference import model as R
from bench.reference.adamw import AdamW
from bench.reference.weights import flat, iter_weights, make_weights

F32 = torch.float32
#: a leaf counts when its reference gradient is at least this share of
#: the median leaf's
LEAF_FLOOR = 1e-3


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def _sequence(prompt, tokens, device) -> tuple[torch.Tensor, int]:
    seq = list(int(t) for t in prompt) + [int(t) for t in tokens[:-1]]
    return torch.tensor(seq, dtype=torch.long, device=device), len(prompt) - 1


def _gaps(lg: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Each row's best logit minus the picked one's, over the row's
    standard deviation."""
    got = lg.gather(1, picked[:, None])[:, 0]
    return (lg.max(1).values - got) / lg.std(1)


def served_gap(params: dict, sz: dict, requests, device) -> float:
    """Widest gap of a served token below the reference's best, over
    ``requests`` ((prompt, served tokens) pairs)."""
    widest = 0.0
    for prompt, tokens in requests:
        seq, start = _sequence(prompt, tokens, device)
        lg = R.logits(params, sz, seq, start)
        picked = torch.tensor(tokens, dtype=torch.long, device=device)
        widest = max(widest, float(_gaps(lg, picked).max()))
        del lg
    return widest


def control_gap(params: dict, sz: dict, requests, device,
                prec: str = "fp8") -> float:
    """The same gap for the tokens that the reference in ``prec`` puts
    first at each served position."""
    widest = 0.0
    for prompt, tokens in requests:
        seq, start = _sequence(prompt, tokens, device)
        lg = R.logits(params, sz, seq, start)
        pick = R.logits(params, sz, seq, start, prec=prec).argmax(1)
        widest = max(widest, float(_gaps(lg, pick).max()))
        del lg
    return widest


def altered_gap(params: dict, sz: dict, requests, device, seed: int
                ) -> float:
    """What one altered token reads: in each request a served position
    and another token id drawn from the seed, the gap of that token below
    the reference's best there; the least over the requests."""
    import numpy as np
    rng = np.random.default_rng([seed, 3])
    least = float("inf")
    for prompt, tokens in requests:
        seq, start = _sequence(prompt, tokens, device)
        lg = R.logits(params, sz, seq, start)
        j = int(rng.integers(len(tokens)))
        alt = int(rng.integers(sz["vocab_size"] - 1))
        alt += alt >= int(tokens[j])
        least = min(least, float(_gaps(lg[j:j + 1], torch.tensor(
            [alt], device=device))[0]))
        del lg
    return least


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _name(path: tuple) -> str:
    return "/".join(path)


def train_reference(sz: dict, seed: int, batches: list[dict], adamw: dict,
                    device, prec: str = "f32") -> dict:
    """The reference's first ``len(batches)`` steps from the run's
    weights: each step's loss, each leaf's clipped first gradient norm,
    and each leaf's change norm after the last step."""
    tree = make_weights(sz, seed, device)
    leaves = flat(tree)
    names = [_name(p) for p, _ in leaves]
    params = [t.to(F32).requires_grad_(True) for _, t in leaves]
    del tree, leaves
    ptree = _unflatten(names, params)
    opt = AdamW(adamw, params)
    losses, grad_norms = [], {}
    with R.exact_matmul():
        for i, b in enumerate(batches):
            loss = R.loss(ptree, sz, b["tokens"], b["labels"], prec)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            losses.append(float(loss.detach()))
            clipped = opt.apply(grads)
            if i == 0:
                grad_norms = {n: float(g.norm()) for n, g in
                              zip(names, clipped)}
                sample = dict(zip(names, sample_leaves(clipped, seed)))
            del loss, grads, clipped
    del opt
    change = {}
    with torch.no_grad():
        for (path, p0), p in zip(iter_weights(sz, seed, device), params):
            change[_name(path)] = float((p - p0.to(F32)).norm())
    return {"loss": losses, "grad_norms": grad_norms, "grad_sample": sample,
            "change_norms": change}


#: elements of each leaf that ``grad_diff`` reads
SAMPLE = 1 << 16


def sample_leaves(leaves: list[torch.Tensor], seed: int,
                  scale: float = 1.0) -> list[torch.Tensor]:
    """``SAMPLE`` elements of each leaf (in order) at places drawn from
    the seed, times ``scale``, on the host; the same places for any
    leaves of the same sizes and device."""
    gen = torch.Generator(device=leaves[0].device).manual_seed(int(seed) + 2)
    out = []
    for t in leaves:
        idx = torch.randint(0, t.numel(), (SAMPLE,), generator=gen,
                            device=t.device)
        out.append((t.detach().reshape(-1)[idx].to(F32) * scale).cpu())
    return out


def _unflatten(names: list[str], leaves: list[torch.Tensor]) -> dict:
    tree: dict = {}
    for n, t in zip(names, leaves):
        node = tree
        *head, last = n.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def _leaf_gaps(got: dict, want: dict, counted: list[str]) -> list[float]:
    med = statistics.median(want[n] for n in counted)
    return [abs(got[n] - want[n]) / max(want[n], med) for n in counted]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap``, ``grad_gap_median`` (the median
    leaf's gap, steady where one small leaf's swings) and ``change_gap``
    of the program's readings against the reference's (the same keys as
    :func:`train_reference` returns)."""
    med = statistics.median(ref["grad_norms"].values())
    counted = [n for n, g in ref["grad_norms"].items()
               if g >= LEAF_FLOOR * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                       ref["loss"]))
    grads = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], counted)
    ref_s = {n: float(ref["grad_sample"][n].norm()) for n in counted}
    diff = {n: float((prog["grad_sample"][n] - ref["grad_sample"][n]).norm())
            for n in counted}
    med_s = statistics.median(ref_s.values())
    return {"loss_gap": loss_gap, "grad_gap": max(grads),
            "grad_gap_median": statistics.median(grads),
            "grad_diff": max(diff[n] / max(ref_s[n], med_s) for n in counted),
            "change_gap": max(_leaf_gaps(prog["change_norms"],
                                         ref["change_norms"], counted))}
