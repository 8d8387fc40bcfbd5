"""Plain PyTorch versions of the LM kernels (the port of
``repro.kernels.ref``).

Each ``*_ref`` function defines what its Hopper kernel computes.  The
kernels' wrappers run them for CPU tensors, the models run them with
``impl="ref"``, and ``chip_smoke.py`` holds each kernel against its plain
version on the card.  They follow ``repro.kernels.ref`` op for op, except
where a docstring says otherwise.  They compute in float32 (float64
for float64 inputs, which lets ``torch.autograd.gradcheck`` hold the
training path's backward, ``kernels/autograd.py``, to them).
"""
from __future__ import annotations

import math

import torch

def _acc(*tensors: torch.Tensor | None) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 when
    an input is float64."""
    return (torch.float64 if any(t is not None and t.dtype == torch.float64
                                 for t in tensors) else torch.float32)


__all__ = ["rmsnorm_ref", "flash_attention_ref", "decode_attention_ref",
           "fused_mlp_ref", "swiglu_backward_ref", "moe_experts_ref",
           "ssd_scan_ref",
           "ssd_sequential_ref", "ssd_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None = None, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Naive attention.

    q: (B, Hq, Sq, Dk); k: (B, Hkv, Sk, Dk); v: (B, Hkv, Sk, Dv); bias:
    (B, Sk) additive (padding masks).  GQA by repeating KV heads.  The
    causal mask lets query i see keys up to ``i + Sk - Sq``.
    """
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    acc = _acc(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :].to(acc)
    if causal:
        Sk = k.shape[2]
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.to(acc))
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Single-token attention.  q: (B, Hq, Dk); k: (B, Hkv, S, Dk); v:
    (B, Hkv, S, Dv), Dv may differ from Dk (MLA's latent cache: Hkv = 1,
    Dk = r + kr, Dv = r).  Returns (B, Hq, Dv).

    ``bias`` (B, S) masks cache slots past each sequence's length.
    """
    out = flash_attention_ref(q[:, :, None], k, v, bias=bias, causal=False,
                              scale=scale)
    return out[:, :, 0]


def fused_mlp_ref(x: torch.Tensor, w_norm: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm -> SwiGLU MLP.  x: (T, d); w_gate/w_up: (d, f); w_down:
    (f, d).  Products accumulate in float32.

    The normalized rows stay in float32, as in the TPU kernel
    (``repro/kernels/fused_mlp.py``), where ``repro.kernels.ref``'s
    version rounds them to x's type first.  In float32 the two agree; in
    bfloat16 they differ by that one rounding.
    """
    acc = _acc(x, w_norm, w_gate, w_up, w_down)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    h = xf * torch.rsqrt(var + eps) * w_norm.to(acc)
    g = h @ w_gate.to(acc)
    u = h @ w_up.to(acc)
    a = torch.nn.functional.silu(g) * u
    return (a @ w_down.to(acc)).to(x.dtype)


def swiglu_backward_ref(g: torch.Tensor, u: torch.Tensor,
                        da: torch.Tensor) -> tuple:
    """SwiGLU's backward (``csrc/fused_mlp_backward.cu``): from the gate
    and up products g, u and the gradient da of ``a = silu(g) * u``, all
    one shape, ``(a, dg, du)`` in the inputs' type, with autograd's own
    operations: ``dg`` is ``silu_backward(da * u, g)``, ``du`` is ``da *
    silu(g)``, so in float64 the three equal ``silu(g) * u`` and its
    autograd bit for bit.  The kernel rounds each to bf16."""
    silu = torch.nn.functional.silu(g)
    return silu * u, torch.ops.aten.silu_backward(da * u, g), da * silu


def moe_experts_ref(h: torch.Tensor, rows: torch.Tensor,
                    offsets: torch.Tensor, gates: torch.Tensor,
                    slots: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor
                    ) -> torch.Tensor:
    """Grouped SwiGLU experts over a dropless routing
    (``csrc/moe_experts.cu``).  h: (T, d) normed tokens; the R = T K
    choices sorted by expert: ``rows`` (R,) their tokens, ``gates`` (R,)
    their weights, ``offsets`` (E + 1,) expert e's rows
    ``offsets[e]:offsets[e + 1]``; ``slots`` (T, K) each token's rows in
    ascending order; w_gate / w_up (E, d, f), w_down (E, f, d).

    Row p of expert e: ``a = silu(h[rows[p]] @ Wg[e]) * (h[rows[p]] @
    Wu[e])``, rounded to h's type, then ``y = gates[p] * (a @ Wd[e])``;
    token t's output is ``0 + y[slots[t, 0]] + ... + y[slots[t, K - 1]]``
    in that order.  Products and sums in float32 (float64 for float64
    inputs).  Returns (T, d) in that type.  It reads the offsets on the
    host: a plain version, not one for a CUDA graph."""
    acc = _acc(h, w_gate, w_up, w_down)
    y = torch.zeros((rows.shape[0], h.shape[1]), dtype=acc, device=h.device)
    off = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = off[e], off[e + 1]
        if lo == hi:
            continue
        x = h[rows[lo:hi].long()].to(acc)
        a = (torch.nn.functional.silu(x @ w_gate[e].to(acc))
             * (x @ w_up[e].to(acc))).to(h.dtype).to(acc)
        y[lo:hi] = gates[lo:hi, None].to(acc) * (a @ w_down[e].to(acc))
    yk = y[slots.long()]                                  # (T, K, d)
    out = torch.zeros_like(yk[:, 0])
    for j in range(yk.shape[1]):
        out = out + yk[:, j]
    return out


# ----------------------------------------------------------------------
# Mamba2 SSD (state-space duality) scan
# ----------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{k=j+1..i} x[..., k]  (-inf for j > i)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(L, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """Broadcast (b, s, g, n) groups to (b, s, h, n) heads."""
    return torch.repeat_interleave(t, rep, dim=2) if rep > 1 else t


def _init(init_state, b, h, p, n, device, acc=torch.float32
          ) -> torch.Tensor:
    if init_state is None:
        return torch.zeros((b, h, p, n), dtype=acc, device=device)
    return init_state.to(acc)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
                 init_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2, arXiv:2405.21060 Listing 1).

    x: (b, s, h, p); dt: (b, s, h) positive steps (already softplus'ed);
    A: (h,) negative decay rates; B, C: (b, s, g, n), the g groups
    broadcast to the heads; ``s`` a multiple of ``chunk``.  Returns
    (y (b, s, h, p) in x's type, final_state (b, h, p, n) float32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g
    f32 = _acc(x, dt, A, B, C, init_state)
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = _heads(B, rep).reshape(b, nc, chunk, h, n).to(f32)
    Cc = _heads(C, rep).reshape(b, nc, chunk, h, n).to(f32)
    dA = (dtc * A.to(f32)).movedim(-1, -2)                  # (b,c,h,l)
    dA_cum = torch.cumsum(dA, dim=-1)

    # 1. within-chunk (the "quadratic attention-like" part)
    Ldec = torch.exp(_segsum(dA))                           # (b,c,h,l,l)
    cb = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    dtx = dtc[..., None] * xc                               # (b,c,l,h,p)
    y_diag = torch.einsum("bchls,bcshp->bclhp", cb * Ldec, dtx)

    # 2. chunk-final states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)     # (b,c,h,l)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Bc, decay_states, dtx)

    # 3. cross-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(dA_cum[..., -1])                # (b,c,h)
    carry = _init(init_state, b, h, p, n, x.device, f32)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (b,c,h,p,n)

    # 4. state -> output within chunk
    state_decay = torch.exp(dA_cum)                         # (b,c,h,l)
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", Cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_sequential_ref(x, dt, A, B, C, init_state=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence, the gold model the chunked scan must
    match: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    f32 = torch.float32
    Bh, Ch = _heads(B, rep).to(f32), _heads(C, rep).to(f32)
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    state = _init(init_state, b, h, p, n, x.device)
    ys = []
    for t in range(s):
        dec = torch.exp(dtf[:, t] * Af)                     # (b,h)
        upd = torch.einsum("bhn,bhp,bh->bhpn", Bh[:, t], xf[:, t], dtf[:, t])
        state = state * dec[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), state


def ssd_ref(x, dt, A, B, C, chunk: int = 64, init_state=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the ``ssd_scan`` kernel: :func:`ssd_scan_ref`
    at any length.  A ragged sequence is padded up to a multiple of
    ``chunk`` with dt = 0 steps (decay exp(0) = 1, zero input), a no-op
    on both outputs and the final state, and y is cropped after, as
    ``repro.kernels.ops.ssd`` does."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    y, final = ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                            init_state=init_state)
    return (y[:, :s] if pad else y), final
