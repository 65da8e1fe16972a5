"""Fused decode MLP ``down(act(gate(x)) * up(x))`` over a fused gate_up
projection: kernel K3 (``csrc/fused_mlp.cu``) and its plain twin.

Counterpart of ``autoawq_tpu/ops/fused_mlp.py`` (``fused_mlp_pallas``). The
twin is ``mlp`` with ``method="jnp"``: gate_up through the W4A16 twin, split,
activation times up in x's dtype, down through the twin.
"""

from __future__ import annotations

from typing import Tuple

import torch

from autoawq_tpu_torch.ops import _build
from autoawq_tpu_torch.ops.gemm import (_check, _sm_count, awq_matmul_plain,
                                        core_ok, gemv_plan)

M_MAX = 32  # decode-size row cap (fused_mlp.M_MAX in the JAX package)
ACTS = {"silu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "gelu_fast": 1,
        "gelu": 2}


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name in ("gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_fast"):
        return torch.nn.functional.gelu(
            x, approximate="none" if name == "gelu" else "tanh")
    if name == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name}")


def supported(m: int, hidden: int, inter: int, gu: dict, dn: dict,
              act: str) -> bool:
    """Shape gate for K3 (the port's ``_fused_mlp_ok`` shape half): what
    the GEMV core takes (``gemm.core_ok``) and inter % 4 == 0, so each
    lane's four up columns start on 16 bytes."""
    return (m <= M_MAX and act in ACTS and inter % 4 == 0
            and gu["qweight"].shape == (hidden // 8, 2 * inter)
            and dn["qweight"].shape == (inter // 8, hidden)
            and "lora_a" not in gu and "lora_a" not in dn
            and core_ok(gu) and core_ok(dn))


def mlp_plan(m: int, h: int, inter: int, n2: int, device: torch.device
             ) -> Tuple[int, int, int]:
    """``(nt, cs1, cs2)`` of K3's and K8's two passes on the GEMV core:
    the n8 tiles a warp (one row group: M <= 32) and each pass's cluster,
    from ``gemm.gemv_plan`` (gate_up: K = h over 2 * inter columns; down:
    K = inter over n2)."""
    sms = _sm_count(device.index or 0)
    nt, _, cs1 = gemv_plan(m, h, 2 * inter, 1, sms)
    _, _, cs2 = gemv_plan(m, inter, n2, 1, sms)
    return nt, cs1, cs2


def fused_mlp_plain(x, gu_qweight, gu_scales, dn_qweight, dn_scales,
                    gu_qzeros=None, dn_qzeros=None, *, inter: int,
                    act: str = "silu") -> torch.Tensor:
    gu = awq_matmul_plain(x, gu_qweight, gu_scales, gu_qzeros)
    g, u = gu[..., :inter], gu[..., inter:2 * inter]
    h = act_fn(act, g) * u
    return awq_matmul_plain(h, dn_qweight, dn_scales, dn_qzeros)


def fused_mlp(x: torch.Tensor, gu_qweight, gu_scales, dn_qweight, dn_scales,
              gu_qzeros=None, dn_qzeros=None, *, inter: int,
              act: str = "silu") -> torch.Tensor:
    """K3: x [..., H] bf16 (M <= 32 rows) -> [..., N2] bf16. Group sizes
    must be multiples of 32, inter and N2 multiples of 4 and the operands
    16-byte aligned, else ValueError."""
    _build.refuse_grad("fused_mlp", x)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, gu_qweight, gu_scales, dn_qweight,
                               dn_scales, gu_qzeros, dn_qzeros, inter=inter,
                               act=act)
    if act not in ACTS:
        raise ValueError(f"fused_mlp: unsupported activation {act!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m, h = x2.shape
    if m > M_MAX:
        raise ValueError(f"fused_mlp: M={m} > {M_MAX}")
    if gu_qweight.shape[1] != 2 * inter or inter % 4:
        raise ValueError("fused_mlp: gate_up must hold 2 * inter columns, "
                         "inter a multiple of 4")
    gs1 = _check(x2, gu_qweight, gu_scales, gu_qzeros, "fused_mlp", 32,
                 aligned=True)
    hbuf = torch.empty((m, inter), dtype=x.dtype, device=x.device)
    gs2 = _check(hbuf, dn_qweight, dn_scales, dn_qzeros, "fused_mlp", 32,
                 aligned=True)
    n2 = dn_qweight.shape[1]
    out = torch.empty((m, n2), dtype=x.dtype, device=x.device)
    nt, cs1, cs2 = mlp_plan(m, h, inter, n2, x.device)
    _build.launch("fused_mlp", x2.data_ptr(), gu_qweight.data_ptr(),
                  gu_scales.data_ptr(), _build.ptr(gu_qzeros),
                  dn_qweight.data_ptr(), dn_scales.data_ptr(),
                  _build.ptr(dn_qzeros), hbuf.data_ptr(), out.data_ptr(),
                  m, h, inter, n2, gs1, gs2, ACTS[act], nt, cs1, cs2)
    return out.reshape(*lead, n2)
