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
``"mla"``), three passes on the device.  The first finds each slot's
live extent in its bias row.  The second lays the slots end to end
and gives each of :func:`mla_plan`'s blocks (one or two an SM) an
equal run of rows, so a long slot spreads over many SMs and short
ones share one; a block streams its rows 16 keys a tile through a
ring of tiles in shared memory filled by bulk copies (TMA) ahead of
the tensor cores, holds the G query rows of the slot it is in, and
runs the logits and P V in 3xTF32 (each operand kept to about 2^-20
of itself).  A slot inside one run is written out there; a slot that
the cut splits leaves a partial state in scratch, and the third pass
merges those in run order, so the output is the same bits from run to
run and a CUDA graph replays the passes with new lengths.  When v is
the first Dv columns of k's rows (the model's latent cache holds
[c_kv ; k_rope] in one row, and v is c_kv), the rows are read once for
both.  The limits: the split instance takes Dk, Dv <=
:data:`MAX_HEAD_DIM` and G <= :data:`MAX_GROUP`; with Hkv = 1 the
latent instance takes G <= :data:`MLA_MAX_GROUP`, Dk <=
:data:`MLA_MAX_DK` and Dv <= :data:`MLA_MAX_DV`, a multiple of 8,
within :func:`route`'s fence.  Other shapes raise.

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

__all__ = ["decode_attention", "DecodePlan", "plan", "MlaPlan", "mla_plan",
           "route", "mla_smem_bytes", "MAX_HEAD_DIM", "MAX_GROUP",
           "SPLIT_KEYS", "MAX_SPLITS", "MLA_TILE", "MLA_MAX_STAGES",
           "MLA_MAX_GROUP", "MLA_MAX_DK", "MLA_MAX_DV"]

#: the largest Dk or Dv the kernel takes
MAX_HEAD_DIM = 128
#: the most query heads per KV head
MAX_GROUP = 16
#: a split's keys are a multiple of this
SPLIT_KEYS = 32
#: the most splits of one KV head: a portable thread-block cluster
MAX_SPLITS = 8
#: the latent instance's ring: keys a tile, and the most tiles it holds
MLA_TILE = 16
MLA_MAX_STAGES = 4
#: the latent instance's limits (Hkv = 1): query heads, Dk and Dv
MLA_MAX_GROUP = 64
MLA_MAX_DK = 576
MLA_MAX_DV = 512
#: dynamic shared memory a latent block may take (Hopper's 227 KB, less
#: the decode pass's static arrays), and each of two blocks on one SM
#: (its 228 KB halved, less 1 KB reserved a block and the static arrays)
_MLA_SMEM = 232448 - 2048
_MLA_SMEM_HALF = 233472 // 2 - 1024 - 2048

_SOURCE = build.CudaSource("decode_attention")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_float, ctypes.c_void_p])
#: the latent launch's: the same with its scratch after the output
_MLA_ARGTYPES = [ctypes.c_void_p] * 6 + _ARGTYPES[5:]


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


@dataclasses.dataclass(frozen=True)
class MlaPlan:
    """The latent instance's launch: ``blocks`` runs of the live rows
    (one or two blocks an SM), a ring of ``stages`` tiles, ``smem`` bytes
    of dynamic shared memory a block."""
    blocks: int
    stages: int
    smem: int


def mla_plan(G: int, Dk: int, Dv: int, v_in_k: bool, q_size: int,
             n_sm: int) -> MlaPlan:
    """The latent instance's host plan (the cut of the live rows among
    the blocks is made on the device, from the bias): two blocks for
    each of the ``n_sm`` SMs at G <= 16 where two rings of two tiles fit
    an SM (so one block's loads, barriers and softmax overlap the other's
    products), else one; each with the deepest ring, at most
    :data:`MLA_MAX_STAGES` tiles, that its share of the SM's shared
    memory holds beside the query rows (``q_size`` bytes an element)."""
    def smem(stages):
        return mla_smem_bytes(G, Dk, Dv, v_in_k, q_size, stages)
    two = G <= 16 and smem(2) <= _MLA_SMEM_HALF
    limit = _MLA_SMEM_HALF if two else _MLA_SMEM
    stages = MLA_MAX_STAGES
    while stages > 2 and smem(stages) > limit:
        stages -= 1
    return MlaPlan(n_sm * (2 if two else 1), stages, smem(stages))


def mla_smem_bytes(G: int, Dk: int, Dv: int, v_in_k: bool, q_size: int,
                   stages: int) -> int:
    """The latent decode pass's dynamic shared memory
    (decode_attention.cu's ``mla::smem_bytes``): the G query rows padded
    to 16 in q's type, ``stages`` tiles of :data:`MLA_TILE` K rows (and V
    rows unless v is in k's rows) in float32, and the logits' partial
    planes."""
    mt = -(-G // 16)
    gp, ks, kg = 16 * mt, _smem_row(Dk), (8, 4, 2, 1)[mt - 1]
    q_bytes = -(-gp * _q_row(Dk, q_size) * q_size // 16) * 16
    stage = MLA_TILE * (ks + (0 if v_in_k else Dv + 8))
    return q_bytes + 4 * (stages * stage + kg * gp * (MLA_TILE + 4))


def _admitted(G: int, Dk: int, Dv: int) -> bool:
    """:func:`route`'s fence for the latent instance, unchanged since the
    instance took Dk 576: the G query rows padded to 16, one 32-key tile
    of K and of V and the logits' planes within a block's 227 KB, less
    1 KB.  Every shape inside it fits :func:`mla_plan`'s ring at two
    tiles or more (tests/test_torch_moe_mla.py holds that)."""
    mt = -(-G // 16)
    gp, ks, kg = 16 * mt, _smem_row(Dk), max(1, 8 // (2 * mt))
    tiles = gp * ks + 32 * ks + 32 * (Dv + 8) + kg * gp * 36
    return 4 * max(tiles, gp * Dv) <= 232448 - 1024


def route(Hq: int, Hkv: int, Dk: int, Dv: int) -> str | None:
    """The instance that takes these shapes: ``"split"`` (G = Hq / Hkv
    <= 16, Dk and Dv <= 128), ``"mla"`` (Hkv = 1 past those limits, up
    to G 64, Dk 576, Dv 512 and a multiple of 8, within
    :func:`_admitted`'s fence; past Dv 256 only at G <= 32), or None
    (refused)."""
    if Hkv <= 0 or Hq % Hkv:
        return None
    G = Hq // Hkv
    if G <= MAX_GROUP and max(Dk, Dv) <= MAX_HEAD_DIM:
        return "split"
    if (Hkv == 1 and G <= MLA_MAX_GROUP and Dk <= MLA_MAX_DK
            and Dv <= (MLA_MAX_DV if G <= 32 else 256) and Dv % 8 == 0
            and _admitted(G, Dk, Dv)):
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
    """The latent instance's shared-memory row of K (and of a float32 q),
    in floats: Dk rounded up to 8 (the tensor cores' depth), then to 4
    mod 32 words, so an mma fragment's loads fall on distinct banks."""
    d8 = -(-Dk // 8) * 8
    return d8 + (4 - d8) % 32


def _q_row(Dk: int, q_size: int) -> int:
    """The latent instance's shared-memory row of q, in q's elements:
    Dk rounded up to 8, then to 4 mod 32 words (as :func:`_smem_row`)."""
    d8 = -(-Dk // 8) * 8
    return _smem_row(Dk) if q_size == 4 else d8 + (8 - d8) % 64


def _mla_scratch_bytes(B: int, G: int, Dv: int, blocks: int) -> int:
    """The latent instance's scratch (decode_attention.cu's
    ``mla::carve``): each slot's extent (two int32, padded to 16 bytes),
    then two partial states a run, each a float32 max and sum per head
    and a G x Dv output."""
    return -(-8 * B // 16) * 16 + 4 * 2 * blocks * G * (2 + Dv)


def _launch_mla(q, k, v, bias, out, q_code, kv_code, scale) -> None:
    B, G, Dk = q.shape
    S, Dv = v.shape[2], v.shape[3]
    v_in_k = _v_in_k(k, v)
    p = mla_plan(G, Dk, Dv, v_in_k, q.element_size(),
                 sm_count(q.device.index or 0))
    per = 16 // q.element_size()
    q_vec = (q.data_ptr() % 16 == 0 and Dk % per == 0
             and all(st % per == 0 for st in q.stride()[:2]))
    scratch = torch.empty(_mla_scratch_bytes(B, G, Dv, p.blocks),
                          dtype=torch.uint8, device=q.device)
    dims = (ctypes.c_int * 12)(B, G, S, Dk, Dv, p.blocks, p.stages,
                               int(_wide_loads(k, v)), int(v_in_k),
                               _smem_row(Dk), int(q_vec),
                               _q_row(Dk, q.element_size()))
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:2], k.stride(0), k.stride(2), v.stride(0), v.stride(2),
        *out.stride()[:2], S if bias is None else bias.stride(0))
    fn = _SOURCE.function("decode_attention_mla_launch", _MLA_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), q_code, kv_code, dims, strides, scale,
                stream_of(q.device))
    _SOURCE.check(rc)


def _wide_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether every K and V row starts on 16 bytes and holds whole
    16-byte vectors: the kernel then reads them with 16-byte loads."""
    per = 16 // k.element_size()
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
               and all(st % per == 0 for st in t.stride()[:3])
               for t in (k, v))
