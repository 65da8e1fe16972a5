"""Three-operand decode MLP ``down(act(gate(x)) * up(x))`` over separate
int4 gate, up and down operands (the checkpoint layout): kernel K8
(``csrc/fused_mlp3.cu``) and its plain twin.

Counterpart of the single-chip part of ``autoawq_tpu/ops/sharded_mlp.py``
(``fused_mlp3_pallas`` :125, ``_jnp_mlp3`` :223). The GSPMD wrapper, which
runs the kernel on each tensor-parallel rank's slice of the intermediate,
waits for the port's parallelism (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops.fused_mlp import ACTS, act_fn
from autoawq_tpu_torch.ops.gemm import (_check, _pad_x_k, awq_matmul_plain,
                                        dequantize, gemv_splits)

M_MAX = 32  # decode-size row cap (sharded_mlp.M_MAX in the JAX package)


def supported(m: int, hidden: int, inter: int, gate: Dict[str, Any],
              up: Dict[str, Any], down: Dict[str, Any], act: str) -> bool:
    """Shape gate for K8, the model half of JAX ``supported`` without its
    TPU tiling gates: three quantized operands without LoRA, no gate or up
    bias, a K8 activation, M <= 32, and the unpadded widths the kernel reads
    (gate and up [hidden/8, inter], down [inter/8, N])."""
    lins = (gate, up, down)
    if not all("qweight" in p and "lora_a" not in p for p in lins):
        return False
    if gate.get("bias") is not None or up.get("bias") is not None:
        return False
    return (m <= M_MAX and act in ACTS
            and gate["qweight"].shape == (hidden // 8, inter)
            and up["qweight"].shape == (hidden // 8, inter)
            and down["qweight"].shape[0] * 8 == inter)


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
    """K8: x [..., H] bf16 (M <= 32 rows) -> [..., N] bf16."""
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
    gs_g = _check(x2, g_qweight, g_scales, g_qzeros, "fused_mlp3", 8)
    gs_u = _check(x2, u_qweight, u_scales, u_qzeros, "fused_mlp3", 8)
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    gs_d = _check(hbuf, d_qweight, d_scales, d_qzeros, "fused_mlp3", 8)
    n2 = d_qweight.shape[1]
    out = torch.empty((m, n2), dtype=x.dtype, device=x.device)
    splits = gemv_splits(m, inter, n2, x.device)
    ws = (torch.empty((splits, m, n2), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    _build.launch("fused_mlp3", x2.data_ptr(), g_qweight.data_ptr(),
                  g_scales.data_ptr(), _build.ptr(g_qzeros),
                  u_qweight.data_ptr(), u_scales.data_ptr(),
                  _build.ptr(u_qzeros), d_qweight.data_ptr(),
                  d_scales.data_ptr(), _build.ptr(d_qzeros), hbuf.data_ptr(),
                  out.data_ptr(), _build.ptr(ws), m, h, inter, n2, gs_g,
                  gs_u, gs_d, ACTS[act], splits)
    return out.reshape(*lead, n2)
