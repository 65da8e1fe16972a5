"""Causal prefill attention: kernel K4 (``csrc/prefill_attention.cu``), its
backward K10 / K11 (``csrc/prefill_attention_bwd.cu``) and their plain twin.

Counterpart of ``autoawq_tpu/nn/modules._flash_prefill`` (jax's stock TPU
flash kernel) for prefill with equal q/k lengths, and of its VJP (the stock
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` kernels). The
twin is the einsum/softmax path of ``nn/modules.attention``
(``modules.py:731-742``): GQA by repeat, f32 scores, additive causal mask,
softmax, probabilities cast to the activations' dtype; its gradient is
autograd through it. Shapes follow ``_flash_prefill``: q [B, S, nh, hd],
k/v [B, S, nkv, hd] -> [B, S, nh * hd]. K4 is built for head dims 64, 128
and 256; the wrapper zero-pads any other head dim up to the next of these
(exact: zero dims add nothing to q·k and give zero output columns, which
are sliced off, and zero gradient columns), as ``_flash_prefill`` pads to a
multiple of 64.

On a CUDA tensor that requires grad, :func:`prefill_attention` runs
:class:`PrefillAttentionFn`: K4 also writes each row's log-sum-exp, and the
backward computes ``D = rowsum(dO * O)`` with a torch op (jax computes
``di`` with jnp outside its kernels), then K10 (dK, dV, summed over each
GQA group: the VJP of the ``jnp.repeat`` at ``modules.py:726-728``) and
K11 (dQ).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from autoawq_tpu_torch.ops import _build

HEAD_DIMS = (64, 128, 256)  # head dims K4, K10 and K11 are built for
BWD_TILE = 64  # rows of K10's and K11's tiles (queries or keys)


def prefill_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float) -> torch.Tensor:
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, s, nh * hd)


def _token_stride(t: torch.Tensor, name: str) -> int:
    """Elements between consecutive tokens; heads and dims must be dense
    and the batch stride S times the token stride."""
    b, s, nh, hd = t.shape
    if t.stride(3) != 1 or t.stride(2) != hd or t.stride(0) != s * t.stride(1):
        raise ValueError(f"prefill_attention: {name} needs dense heads/dims "
                         f"and batch stride S * token stride, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16 or t.stride(1) % 8:
        raise ValueError(f"prefill_attention: {name} must start on a 16-byte "
                         "boundary with a token stride a multiple of 8 (the "
                         "kernel loads 8 bf16 at once)")
    return t.stride(1)


def _prepare(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Check a kernel call and zero-pad the head dim to K4's instance:
    returns (q, k, v padded, the padded head dim)."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if k.shape != (b, s, nkv, hd) or v.shape != k.shape:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if nh % nkv:
        raise ValueError(f"prefill_attention: heads {nh}/{nkv}")
    if hd > HEAD_DIMS[-1]:
        raise NotImplementedError(
            f"prefill_attention: head dim {hd} > {HEAD_DIMS[-1]} is not in "
            "the port yet (ROADMAP queue 2, K4 speed work)")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError("prefill_attention: q, k, v must be bfloat16 on "
                            "one device")
    hd_pad = next(d for d in HEAD_DIMS if d >= hd)
    if hd_pad != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, hd_pad - hd))
                   for t in (q, k, v))
    return q, k, v, hd_pad


def _strides(q, k, v):
    return [_token_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v"))]


def _k4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K4 on prepared operands: (out [B, S, nh * hd_pad] bf16,
    the rows' f32 log-sum-exp [B, nh, S] or None)."""
    b, s, nh, hd_pad = q.shape
    nkv = k.shape[2]
    strides = _strides(q, k, v)
    out = torch.empty((b, s, nh * hd_pad), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _build.launch("prefill_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), _build.ptr(lse), b, s, nh,
                  nkv, hd_pad, *strides, float(scale))
    return out, lse


def _slice_heads(out: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, s, width = out.shape
    hd_pad = width // nh
    if hd_pad == hd:
        return out
    return out.view(b, s, nh, hd_pad)[..., :hd].reshape(b, s, nh * hd)


def prefill_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 with its log-sum-exp output: (out [B, S, nh * hd], lse f32
    [B, nh, S], the natural log of each row's sum of exp(scale * q·k) over
    its causal keys). CUDA tensors only."""
    nh, hd = q.shape[2], q.shape[3]
    qp, kp, vp, _ = _prepare(q, k, v)
    out, lse = _k4(qp, kp, vp, scale, with_lse=True)
    return _slice_heads(out, nh, hd), lse


def bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """The operands of K10 and K11, checked and padded: (q, k, v, dO,
    LSE, D, the padded head dim), with ``D = rowsum(dO * O)`` in f32, the
    torch op jax's ``_flash_attention_bwd`` computes with jnp."""
    b, s, nh, hd = q.shape
    qp, kp, vp, hd_pad = _prepare(q, k, v)
    if lse.shape != (b, nh, s) or lse.dtype != torch.float32:
        raise ValueError(f"prefill_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want ({b}, {nh}, {s}) float32")
    do = dout.reshape(b, s, nh, hd).to(torch.bfloat16)
    # over the real head dims (pad columns of dO and O add zero)
    delta = (do.float() * out.reshape(b, s, nh, hd).float()).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    if hd_pad != hd:
        do = torch.nn.functional.pad(do, (0, hd_pad - hd))
    return qp, kp, vp, do.contiguous(), lse.contiguous(), delta, hd_pad


def bwd_schedule(s: int, hd: int
                 ) -> Tuple[List[Tuple[int, ...]], List[int],
                            List[Tuple[int, ...]], List[int]]:
    """The causal schedules K10 and K11 launch at sequence length ``s`` and
    (padded) head dim ``hd``, along the tile axis of one (head, batch):
    (K10's key tiles and steps a query head for each CTA, K11's query tiles
    and key tiles streamed for each work item). K10's CTA p takes key tile
    p and its mirror ``nq - 1 - p`` and walks, for each query head of its
    group, the query tiles at or after each (``nq - kt`` steps). K11's work
    item p takes query tile p of 128 rows (two warpgroups of 64; 64 rows,
    one warpgroup, at hd 256) and its mirror, and streams the key tiles up
    to each one's diagonal; one persistent CTA per SM walks the items of
    all heads. Pairing a tile with its mirror gives every CTA (K10) or
    item (K11) the same work (the middle tile of an odd count rides
    alone)."""
    nq = -(-s // BWD_TILE)
    dkv = [tuple(sorted({p, nq - 1 - p})) for p in range((nq + 1) // 2)]
    rows = BWD_TILE * (2 if hd <= 128 else 1)
    nr = -(-s // rows)
    dq = [tuple(sorted({p, nr - 1 - p})) for p in range((nr + 1) // 2)]
    return (dkv, [sum(nq - kt for kt in c) for c in dkv], dq,
            [sum(min((t + 1) * rows // BWD_TILE, nq) for t in c)
             for c in dq])


def _common(ops, scale):
    qp, kp, vp, do, lse, delta, hd_pad = ops
    b, s, nh, _ = qp.shape
    return (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()), (
                b, s, nh, kp.shape[2], hd_pad, *_strides(qp, kp, vp),
                float(scale))


def launch_dkv(ops, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 on :func:`bwd_inputs`' operands: (dk, dv) [B, S, nkv, hd_pad]."""
    ptrs, dims = _common(ops, scale)
    kp = ops[1]
    dk = torch.empty(kp.shape, dtype=kp.dtype, device=kp.device)
    dv = torch.empty_like(dk)
    _build.launch("prefill_attention_dkv", *ptrs, dk.data_ptr(),
                  dv.data_ptr(), *dims)
    return dk, dv


def launch_dq(ops, scale: float) -> torch.Tensor:
    """K11 on :func:`bwd_inputs`' operands: dq [B, S, nh, hd_pad]."""
    ptrs, dims = _common(ops, scale)
    qp = ops[0]
    dq = torch.empty(qp.shape, dtype=qp.dtype, device=qp.device)
    _build.launch("prefill_attention_dq", *ptrs, dq.data_ptr(), *dims)
    return dq


def prefill_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          dout: torch.Tensor, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K10 and K11: (dq, dk, dv) shaped as q, k, v, from the forward's
    inputs, its output ``out`` [B, S, nh * hd] and ``lse`` [B, nh, S], and
    the output's gradient ``dout``. CUDA tensors only."""
    hd = q.shape[3]
    ops = bwd_inputs(q, k, v, out, lse, dout)
    dk, dv = launch_dkv(ops, scale)
    dq = launch_dq(ops, scale)
    if ops[-1] != hd:
        dq, dk, dv = (t[..., :hd] for t in (dq, dk, dv))
    return dq, dk, dv


class PrefillAttentionFn(torch.autograd.Function):
    """K4 forward (with its log-sum-exp), K10 and K11 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = prefill_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd(q, k, v, out, lse, dout,
                                           ctx.scale)
        return dq, dk, dv, None


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """K4: causal attention over equal-length q/k (prefill from position 0);
    differentiable (K10 / K11) when an input requires grad."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, scale)
    if _build.grad_wanted(q, k, v):
        return PrefillAttentionFn.apply(q, k, v, float(scale))
    nh, hd = q.shape[2], q.shape[3]
    qp, kp, vp, _ = _prepare(q, k, v)
    out, _ = _k4(qp, kp, vp, scale, with_lse=False)
    return _slice_heads(out, nh, hd)
