"""autoawq_tpu_torch — the PyTorch / CUDA port of ``autoawq_tpu`` for NVIDIA
Hopper (H100).

W4A16 inference and AWQ quantization of the decoder zoo (every architecture
of the JAX package but MLA and MoE beyond Mixtral): plain PyTorch for the
tensor code, hand-written CUDA kernels (``csrc/``) for the nine TPU
kernels. The JAX package stays the reference; the port imports nothing of
it, nor jax.
"""

__version__ = "0.1.0"

from autoawq_tpu_torch.config import AwqConfig  # noqa: F401
from autoawq_tpu_torch.api import (AutoAWQForCausalLM,  # noqa: F401
                                   AwqCausalLM, AwqLlavaModel,
                                   AwqQwen2VLModel)
from autoawq_tpu_torch.models.config import ModelConfig  # noqa: F401
