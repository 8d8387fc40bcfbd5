"""The weights of a run, made by the benchmark from ``--seed``.

Both sides get these tensors: the program serves or trains them, and
the reference reads the same values (:mod:`bench.reference.model`).
They are drawn on the device from one ``torch.Generator`` seeded with
the run's seed, one call per stacked leaf, in the type they are served
in (the configuration's ``dtype``), and laid out as the port's parameter tree: every block leaf
stacked on a leading layer axis, keys as the port names them.

The laws follow the usual initialisation of the family: matrices normal
with standard deviation 1/sqrt(fan in) (the embedding 0.02), norms
one.  Every family has ``embed``, ``final_ln`` and, untied, ``lm_head``;
the family's reference (``bench/reference/families/<family>.py``) gives
the rest of the tree in ``leaves(sz)``, built from :func:`matrix`,
:func:`ones` and :func:`stacked`.
"""
from __future__ import annotations

import math
from typing import Iterator

import torch

from bench import families


def matrix(*shape: int, std: float | None = None) -> tuple:
    """A normal leaf, standard deviation ``std`` or 1/sqrt(fan in)."""
    return shape, "normal", std


def ones(*shape: int) -> tuple:
    """A leaf of ones (a norm's weight)."""
    return shape, "ones", None


def stacked(tree: dict, n: int) -> dict:
    """``tree``'s leaves stacked on a leading axis of ``n`` layers."""
    return {k: stacked(v, n) if isinstance(v, dict)
            else ((n,) + v[0], v[1], v[2]) for k, v in tree.items()}


def _spec(sz: dict) -> dict:
    """(shape, law, std) for every leaf, as a tree."""
    d, V = sz["d_model"], sz["vocab_size"]
    tree = {"embed": matrix(V, d, std=0.02), "final_ln": ones(d),
            **families.reference(sz["family"]).leaves(sz)}
    if not sz.get("tie_embeddings", False):
        tree["lm_head"] = matrix(d, V)
    return tree


def leaves(sz: dict) -> Iterator[tuple[tuple, tuple, str, float | None]]:
    """(path, shape, law, std) of every leaf in sorted-key order, the
    order in which they are drawn."""
    def walk(t, prefix):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), *v
    yield from walk(_spec(sz), ())


def _draw(shape, law, std, gen, dtype, device) -> torch.Tensor:
    f32 = torch.float32
    if law == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = std if std is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=f32, device=device)
    return x.mul_(s).to(dtype)


def iter_weights(sz: dict, seed: int, device) -> Iterator[tuple[tuple,
                                                               torch.Tensor]]:
    """(path, tensor) of every leaf, drawn in order from the seed; one
    leaf alive at a time if the caller lets each go."""
    dtype = getattr(torch, sz["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for path, shape, law, std in leaves(sz):
        yield path, _draw(shape, law, std, gen, dtype, device)


def make_weights(sz: dict, seed: int, device) -> dict:
    """The whole parameter tree of a run."""
    tree: dict = {}
    for path, t in iter_weights(sz, seed, device):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def flat(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (flat(v, prefix + (k,)) if isinstance(v, dict)
                else [(prefix + (k,), v)])
    return out
