"""Decode (single-token) attention: the Hopper kernel and its wrapper.

Replaces the TPU kernel ``decode_attention`` / ``_kernel``
(``src/repro/kernels/decode_attention.py``) with a hand-written CUDA
kernel, ``csrc/decode_attention.cu``: one query token per sequence
against an S-long KV cache, the ``G = Hq / Hkv`` query heads of a KV
head handled together, an online softmax over the keys, and a (B, S)
bias that carries each slot's length mask.

q and the cache may differ in type: the serving path's query is
bfloat16 and the batcher's cache float32.  The kernel converts each
operand to float32 as it loads it, so nothing is cast before the
launch; the output has q's type, as on the TPU.

What bounds it on the card: the bytes of the live cache, read once
(about a microsecond at the serving shapes).  So the kernel splits S
across blocks (:func:`plan` picks the splits that fill two waves of
the SMs, at most 8 a KV head), reads each key row with 16-byte loads,
keeps the softmax state in registers, skips the keys the bias masks
(bias <= NEG_INF / 2: their p is exactly 0 in the reference), and
makes the splits of a KV head one thread-block cluster whose first
block merges their states from distributed shared memory in split
order, so the output is the same bits from run to run.

MLA's absorbed decode is MQA over the latent cache: one KV head
(Hkv = 1) for all G query heads, keys of Dk = kv_lora_rank +
rope_head_dim and values of Dv = kv_lora_rank (minicpm3-4b: G = 40,
Dk = 288, Dv = 256; deepseek-v2-lite: G = 16, Dk = 576, Dv = 512).
Those shapes take the kernel's latent instance (:func:`route` gives
``"mla"``): a block per (slot, split) holds the G query rows in shared
memory, loads each live key row once for all of them, runs the logits
and P V on the tensor cores in 3xTF32 (about float32's accuracy) with
the (G, Dv) accumulator spread over its warps (32 columns a warp, 64
past Dv 256, which G <= 32 takes) and, at G <= 32, each logits tile's
depth split over several warps;
the splits of a slot (at most 16, a non-portable cluster size) merge in
a cluster as above.  When v is the first Dv columns of k's rows (the
model's latent cache holds [c_kv ; k_rope] in one row, and v is c_kv),
the rows are read once for both.  The limits:
the split instance takes Dk, Dv <= :data:`MAX_HEAD_DIM` and G <=
:data:`MAX_GROUP`; with Hkv = 1 the latent instance takes G <=
:data:`MLA_MAX_GROUP`, Dk <= :data:`MLA_MAX_DK` and Dv <=
:data:`MLA_MAX_DV`, a multiple of 8, where its shared memory
(:func:`mla_smem_bytes`) fits.  Other shapes raise.

:func:`decode_attention` launches the kernel for CUDA tensors, adding
one to ``decode_attention.launches`` (and to ``mla_launches`` for the
latent instance), and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import (call_device, dtype_code, sm_count,
                                        stream_of)
from repro_torch.kernels.ref import decode_attention_ref

__all__ = ["decode_attention", "DecodePlan", "plan", "mla_plan", "route",
           "mla_smem_bytes", "MAX_HEAD_DIM", "MAX_GROUP", "SPLIT_KEYS",
           "MAX_SPLITS", "MLA_MAX_SPLITS", "MLA_MAX_GROUP", "MLA_MAX_DK",
           "MLA_MAX_DV"]

#: the largest Dk or Dv the kernel takes
MAX_HEAD_DIM = 128
#: the most query heads per KV head
MAX_GROUP = 16
#: a split's keys are a multiple of this
SPLIT_KEYS = 32
#: the most splits of one KV head: a portable thread-block cluster
MAX_SPLITS = 8
#: the most splits of a slot in the latent instance: a non-portable
#: cluster of 16, which the instance opts into
MLA_MAX_SPLITS = 16
#: the latent instance's limits (Hkv = 1): query heads, Dk and Dv
MLA_MAX_GROUP = 64
MLA_MAX_DK = 576
MLA_MAX_DV = 512
#: dynamic shared memory a latent block may take (Hopper's 227 KB, less
#: the instance's static arrays)
_MLA_SMEM = 232448 - 1024

_SOURCE = build.CudaSource("decode_attention")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How a launch cuts S: ``splits`` blocks (one cluster) of
    ``keys_per_split`` keys per (sequence, KV head), ``blocks`` in all."""
    keys_per_split: int
    splits: int
    blocks: int


def plan(B: int, Hkv: int, S: int, n_sm: int) -> DecodePlan:
    """The fewest splits (at most :data:`MAX_SPLITS`) that give the
    B * Hkv heads two blocks an SM, each a multiple of
    :data:`SPLIT_KEYS` keys long."""
    heads = B * Hkv
    want = min(MAX_SPLITS, max(1, -(-2 * n_sm // heads)))
    kps = -(-S // want)
    kps = -(-kps // SPLIT_KEYS) * SPLIT_KEYS
    splits = -(-S // kps)
    return DecodePlan(kps, splits, heads * splits)


def mla_plan(B: int, S: int, n_sm: int) -> DecodePlan:
    """The latent instance's cut: as many splits of a slot as a cluster
    holds (at most :data:`MLA_MAX_SPLITS`), but no more than give the B
    slots two blocks for each of the ``n_sm`` SMs (a block of a wide instance
    fills an SM, and a slot's cluster holds all of its SMs until its
    busiest split ends: at 64 slots, 5 splits read 27 % faster than 15,
    PERF.md); each a multiple of :data:`SPLIT_KEYS` keys (one tile a
    step)."""
    want = min(MLA_MAX_SPLITS, -(-S // SPLIT_KEYS), -(-2 * n_sm // B))
    kps = -(-S // want)
    kps = -(-kps // SPLIT_KEYS) * SPLIT_KEYS
    splits = -(-S // kps)
    return DecodePlan(kps, splits, B * splits)


def mla_smem_bytes(G: int, Dk: int, Dv: int, v_in_k: bool = False) -> int:
    """The latent instance's dynamic shared memory (decode_attention.cu's
    ``mla::smem_floats``): the G query rows padded to 16, a 32-key tile
    of K (and of V unless v is in k's rows), the logits' partial planes,
    or the merge's (G, Dv) accumulator, whichever is larger."""
    mt = -(-G // 16)
    gp, ks, kg = 16 * mt, _smem_row(Dk), max(1, 8 // (2 * mt))
    tiles = (gp * ks + 32 * ks + (0 if v_in_k else 32 * (Dv + 8))
             + kg * gp * 36)
    return 4 * max(tiles, gp * Dv)


def route(Hq: int, Hkv: int, Dk: int, Dv: int) -> str | None:
    """The instance that takes these shapes: ``"split"`` (G = Hq / Hkv
    <= 16, Dk and Dv <= 128), ``"mla"`` (Hkv = 1 past those limits, up
    to G 64, Dk 576, Dv 512 and a multiple of 8, where its shared memory
    fits with V rows of their own; past Dv 256 only at G <= 32), or None
    (refused)."""
    if Hkv <= 0 or Hq % Hkv:
        return None
    G = Hq // Hkv
    if G <= MAX_GROUP and max(Dk, Dv) <= MAX_HEAD_DIM:
        return "split"
    if (Hkv == 1 and G <= MLA_MAX_GROUP and Dk <= MLA_MAX_DK
            and Dv <= (MLA_MAX_DV if G <= 32 else 256) and Dv % 8 == 0
            and mla_smem_bytes(G, Dk, Dv) <= _MLA_SMEM):
        return "mla"
    return None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Dk); k: (B, Hkv, S, Dk); v: (B, Hkv, S, Dv); bias:
    (B, S) additive mask.  Returns (B, Hq, Dv) in q's type.

    The kernel on the card, the plain version on the CPU.
    """
    dev = call_device("decode_attention", q, k, v, bias)
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, bias=bias, scale=scale)
    out, which = _launch(q, k, v, bias, scale)
    if which is not None:                  # an empty output launches none
        decode_attention.launches += 1
        if which == "mla":
            decode_attention.mla_launches += 1
    return out


#: every launch, and the latent instance's own
decode_attention.launches = 0
decode_attention.mla_launches = 0


def _launch(q, k, v, bias, scale) -> tuple[torch.Tensor, str | None]:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q must be (B, Hq, D) and k, v "
                         "(B, Hkv, S, D)")
    B, Hq, Dk = q.shape
    _, Hkv, S, Dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != Dk
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    which = route(Hq, Hkv, Dk, Dv)
    if which is None:
        raise ValueError(
            f"decode_attention: Dk {Dk}, Dv {Dv}, group {Hq // Hkv} of Hkv "
            f"{Hkv} too large (max {MAX_HEAD_DIM} and {MAX_GROUP}; with "
            f"Hkv = 1: Dk {MLA_MAX_DK}, Dv {MLA_MAX_DV}, group "
            f"{MLA_MAX_GROUP})")
    if S == 0:
        raise ValueError("decode_attention: the cache is empty")
    if k.dtype != v.dtype:
        raise ValueError(f"decode_attention: k is {k.dtype}, v is {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name}'s last dim must be "
                             f"contiguous")
    q_code = dtype_code("decode_attention", "q", q)
    kv_code = dtype_code("decode_attention", "k", k)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out, None
    if bias is not None:
        if tuple(bias.shape) != (B, S):
            raise ValueError(f"decode_attention: bias must be ({B}, {S}), "
                             f"got {tuple(bias.shape)}")
        bias = bias.to(torch.float32).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    if which == "mla":
        _launch_mla(q, k, v, bias, out, q_code, kv_code, float(scale))
        return out, which
    p = plan(B, Hkv, S, sm_count(q.device.index or 0))
    dims = (ctypes.c_int * 9)(B, Hq, Hkv, S, Dk, Dv, p.keys_per_split,
                              p.splits, int(_wide_loads(k, v)))
    strides = (ctypes.c_longlong * 11)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
        S if bias is None else bias.stride(0))
    fn = _SOURCE.function("decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                q_code, kv_code, dims, strides, float(scale),
                stream_of(q.device))
    _SOURCE.check(rc)
    return out, which


def _v_in_k(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether v's rows are the first Dv columns of k's (the latent
    cache's c_kv inside [c_kv ; k_rope]): then each row is read once."""
    return (v.data_ptr() == k.data_ptr() and v.shape[-1] <= k.shape[-1]
            and v.stride(0) == k.stride(0) and v.stride(2) == k.stride(2))


def _smem_row(Dk: int) -> int:
    """The latent instance's shared-memory row of q and K, in floats: Dk
    rounded up to 8 (the tensor cores' depth), then to 4 mod 32 words, so
    an mma fragment's loads fall on distinct banks."""
    d8 = -(-Dk // 8) * 8
    return d8 + (4 - d8) % 32


def _launch_mla(q, k, v, bias, out, q_code, kv_code, scale) -> None:
    B, G, Dk = q.shape
    S, Dv = v.shape[2], v.shape[3]
    p = mla_plan(B, S, sm_count(q.device.index or 0))
    per = 16 // q.element_size()
    q_vec = (q.data_ptr() % 16 == 0 and Dk % per == 0
             and all(st % per == 0 for st in q.stride()[:2]))
    dims = (ctypes.c_int * 11)(B, G, S, Dk, Dv, p.keys_per_split, p.splits,
                               int(_wide_loads(k, v)), int(_v_in_k(k, v)),
                               _smem_row(Dk), int(q_vec))
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:2], k.stride(0), k.stride(2), v.stride(0), v.stride(2),
        *out.stride()[:2], S if bias is None else bias.stride(0))
    fn = _SOURCE.function("decode_attention_mla_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                q_code, kv_code, dims, strides, scale, stream_of(q.device))
    _SOURCE.check(rc)


def _wide_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether every K and V row starts on 16 bytes and holds whole
    16-byte vectors: the kernel then reads them with 16-byte loads."""
    per = 16 // k.element_size()
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
               and all(st % per == 0 for st in t.stride()[:3])
               for t in (k, v))
