"""Tensor, expert, data and pipeline parallelism over ``torch.distributed``.

The entry points, imported from their modules on first use (the modules
import ``nn/modules``, which imports this package's mesh):
``initialize``, ``hybrid_mesh`` and ``reduce_scatter`` (``distributed``),
``build_mesh`` (``mesh``), ``shard_params`` (``specs``), ``stack_layers``,
``unstack_layers``, ``to_pipeline``, ``pipeline_forward`` and
``pipeline_lora_step`` (``pipeline``). Sequence parallelism is
``nn/modules.forward(..., sequence_parallel=mesh.axis("tensor"))`` on a
rank's ``shard_params`` tree.
"""

import importlib

_EXPORTS = {"initialize": "distributed", "hybrid_mesh": "distributed",
            "reduce_scatter": "distributed", "build_mesh": "mesh",
            "shard_params": "specs",
            "stack_layers": "pipeline", "unstack_layers": "pipeline",
            "to_pipeline": "pipeline", "pipeline_forward": "pipeline",
            "pipeline_lora_step": "pipeline"}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
