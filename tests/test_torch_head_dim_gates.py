"""The head-dim gates of K4 and K7 on the card: a prompt or a paged step
whose head dim is above the widest instance (256) takes the plain route
(``_attend``; the gather) instead of reaching a wrapper that raises, as
JAX computes both. On the CPU the twins take any head dim, so the gates
pass there. A tensor on the ``meta`` device stands for a card's (its
device type is not "cpu"); nothing runs on it."""

import pytest
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops import attention, paged_attn


def _q(device, hd, s=128, nh=4):
    return torch.empty((1, s, nh, hd), device=device)


@pytest.mark.parametrize("hd", [64, 96, 128, 256, 320, 512])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k4_gate_by_head_dim_and_device(hd, device):
    cfg = ModelConfig(hidden_size=4 * hd, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=hd)
    q, k = _q(device, hd), _q(device, hd, nh=2)
    want = device == "cpu" or hd <= attention.HEAD_DIMS[-1]
    assert modules._flash_ok(cfg, "auto", q, k) == want
    assert not modules._flash_ok(cfg, "plain", q, k)


@pytest.mark.parametrize("hd", [64, 128, 256, 320, 512])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k7_gate_by_head_dim_and_device(hd, device):
    q = torch.empty((8, 1, 4, hd), device=device)
    want = device == "cpu" or hd <= paged_attn.HEAD_DIM_MAX
    assert modules._k7_takes(q, 2, 64) == want


def test_wrappers_still_raise_on_direct_calls_at_head_dim_320():
    """The gates route around the wrappers; a direct call on the card
    keeps its refusal (checked before any launch)."""
    assert 320 > attention.HEAD_DIMS[-1]
    assert not paged_attn.supported(4, 2, 320, 64)
