"""Three-operand decode MLP ``down(act(gate(x)) * up(x))`` over separate
int4 gate, up and down operands (the checkpoint layout): kernel K8
(``csrc/fused_mlp3.cu``) and its plain twin.

Counterpart of ``autoawq_tpu/ops/sharded_mlp.py`` (``fused_mlp3_pallas``
:125, ``_jnp_mlp3`` :223, and its GSPMD wrapper ``fused_mlp_sharded``
:365 with ``_local_mlp3`` :237). Under tensor parallelism each rank holds
the column shards of gate and up and the row shard of down for its I/t
slice of the intermediate (``parallel/specs.shard_params``):
:func:`fused_mlp_sharded` runs K8 on that slice and all-reduces the
partial output in f32 over the tensor group, then adds down's bias once.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops.fused_mlp import ACTS, act_fn, mlp_plan
from autoawq_tpu_torch.ops.gemm import (_check, _pad_x_k, awq_matmul_plain,
                                        core_ok, dequantize)

M_MAX = 32  # decode-size row cap (sharded_mlp.M_MAX in the JAX package)


def supported(m: int, hidden: int, inter: int, gate: Dict[str, Any],
              up: Dict[str, Any], down: Dict[str, Any], act: str) -> bool:
    """Shape gate for K8, the model half of JAX ``supported`` without its
    TPU tiling gates: three quantized operands without LoRA, no gate or up
    bias, a K8 activation, M <= 32, and the unpadded widths the kernel reads
    (gate and up [hidden/8, inter], down [inter/8, N]), what the GEMV core
    takes (``gemm.core_ok``), and one group size for gate and up."""
    lins = (gate, up, down)
    if not all("qweight" in p and "lora_a" not in p for p in lins):
        return False
    if gate.get("bias") is not None or up.get("bias") is not None:
        return False
    return (m <= M_MAX and act in ACTS
            and gate["qweight"].shape == (hidden // 8, inter)
            and up["qweight"].shape == (hidden // 8, inter)
            and down["qweight"].shape == (inter // 8, hidden)
            and gate["scales"].shape == up["scales"].shape
            and all(core_ok(p) for p in lins))


def fused_mlp3_plain(x, g_qweight, g_scales, u_qweight, u_scales, d_qweight,
                     d_scales, g_qzeros=None, u_qzeros=None, d_qzeros=None, *,
                     inter: int, act: str = "silu") -> torch.Tensor:
    """``_jnp_mlp3``: the gate and up products stay in f32 (weights
    dequantized to x's dtype), ``h = act(g) * u`` is rounded to x's dtype,
    and down returns x's dtype."""
    xp = _pad_x_k(x, g_qweight).float()
    g = torch.matmul(xp, dequantize(g_qweight, g_scales, g_qzeros,
                                    dtype=x.dtype).float())[..., :inter]
    u = torch.matmul(xp, dequantize(u_qweight, u_scales, u_qzeros,
                                    dtype=x.dtype).float())[..., :inter]
    h = (act_fn(act, g) * u).to(x.dtype)
    return awq_matmul_plain(h, d_qweight, d_scales, d_qzeros)


def fused_mlp3(x: torch.Tensor, g_qweight, g_scales, u_qweight, u_scales,
               d_qweight, d_scales, g_qzeros=None, u_qzeros=None,
               d_qzeros=None, *, inter: int, act: str = "silu"
               ) -> torch.Tensor:
    """K8: x [..., H] bf16 (M <= 32 rows) -> [..., N] bf16. Group sizes
    must be multiples of 32 (one for gate and up), inter and N multiples of
    4 and the operands 16-byte aligned, else ValueError."""
    _build.refuse_grad("fused_mlp3", x)
    if x.device.type == "cpu":
        return fused_mlp3_plain(x, g_qweight, g_scales, u_qweight, u_scales,
                                d_qweight, d_scales, g_qzeros, u_qzeros,
                                d_qzeros, inter=inter, act=act)
    if act not in ACTS:
        raise ValueError(f"fused_mlp3: unsupported activation {act!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m, h = x2.shape
    if m > M_MAX:
        raise ValueError(f"fused_mlp3: M={m} > {M_MAX}")
    if g_qweight.shape[1] != inter or u_qweight.shape[1] != inter:
        raise ValueError("fused_mlp3: gate and up must hold inter columns")
    gs_g = _check(x2, g_qweight, g_scales, g_qzeros, "fused_mlp3", 32,
                  aligned=True)
    gs_u = _check(x2, u_qweight, u_scales, u_qzeros, "fused_mlp3", 32,
                  aligned=True)
    if gs_g != gs_u:
        raise ValueError(f"fused_mlp3: gate and up group sizes {gs_g} and "
                         f"{gs_u} differ (the kernel takes one)")
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    gs_d = _check(hbuf, d_qweight, d_scales, d_qzeros, "fused_mlp3", 32,
                  aligned=True)
    n2 = d_qweight.shape[1]
    out = torch.empty((m, n2), dtype=x.dtype, device=x.device)
    nt, cs1, cs2 = mlp_plan(m, h, inter, n2, x.device)
    _build.launch("fused_mlp3", x2.data_ptr(), g_qweight.data_ptr(),
                  g_scales.data_ptr(), _build.ptr(g_qzeros),
                  u_qweight.data_ptr(), u_scales.data_ptr(),
                  _build.ptr(u_qzeros), d_qweight.data_ptr(),
                  d_scales.data_ptr(), _build.ptr(d_qzeros), hbuf.data_ptr(),
                  out.data_ptr(), m, h, inter, n2, gs_g, gs_d, ACTS[act], nt,
                  cs1, cs2)
    return out.reshape(*lead, n2)


def fused_mlp_sharded(x: torch.Tensor, gate: Dict[str, Any],
                      up: Dict[str, Any], down: Dict[str, Any], *,
                      inter: int, act: str = "silu") -> torch.Tensor:
    """K8 on this rank's LINs (``inter`` the local width), then, for a
    ``down`` marked ``tp_psum``, the f32 sum over its tensor group; down's
    bias after the sum. Unmarked LINs are the one-rank MLP."""
    from autoawq_tpu_torch.ops.sharded_gemm import reduce_rows

    y = fused_mlp3(x, gate["qweight"], gate["scales"], up["qweight"],
                   up["scales"], down["qweight"], down["scales"],
                   gate.get("qzeros"), up.get("qzeros"), down.get("qzeros"),
                   inter=inter, act=act)
    axis = down.get("tp_psum")
    if axis is not None:
        return reduce_rows(y, axis, down.get("bias"))
    if down.get("bias") is not None:
        y = y + down["bias"].to(y.dtype)
    return y
