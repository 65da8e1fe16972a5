"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
jax nor the JAX package nor the libraries the card's machine lacks, builds
no kernel, and its entry points refuse to carry on silently on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "autoawq_tpu", "ml_dtypes", "safetensors",
             "transformers")


def test_port_imports_nothing_forbidden():
    code = (
        "import sys\n"
        "import autoawq_tpu_torch, chip_smoke\n"
        "from autoawq_tpu_torch import api, convert\n"
        "from autoawq_tpu_torch.io import hf, safetensors, serialize\n"
        "from autoawq_tpu_torch.nn import fuse, modules\n"
        "from autoawq_tpu_torch.ops import _build, attention, fused_mlp, gemm\n"
        "from autoawq_tpu_torch.serve import generate\n"
        "from autoawq_tpu_torch.utils import synth\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "bad += list(_build._libs)  # no kernel is built at import\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card(no_card, tmp_path):
    from autoawq_tpu_torch import AutoAWQForCausalLM, AwqCausalLM, ModelConfig
    from autoawq_tpu_torch.api import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    cfg = ModelConfig(num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AwqCausalLM(cfg, {})
    (tmp_path / "config.json").write_text('{"model_type": "llama"}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoAWQForCausalLM.from_quantized(str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_card(no_card):
    import chip_smoke

    assert chip_smoke.main([]) == 1


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    """Alone in a directory, the script fails before looking for a card."""
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        script.write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "autoawq_tpu_torch/ beside this script" in res.stderr
    assert '"ok"' not in res.stdout
