"""autoawq_tpu_torch — the PyTorch / CUDA port of ``autoawq_tpu`` for NVIDIA
Hopper (H100).

W4A16 inference of llama-family AWQ checkpoints: plain PyTorch for the
tensor code, hand-written CUDA kernels (``csrc/``) for the four TPU kernels
on the main path. The JAX package stays the reference; the port imports
nothing of it, nor jax.
"""

__version__ = "0.1.0"

from autoawq_tpu_torch.config import AwqConfig  # noqa: F401
from autoawq_tpu_torch.api import AutoAWQForCausalLM, AwqCausalLM  # noqa: F401
from autoawq_tpu_torch.models.config import ModelConfig  # noqa: F401
