"""Tensor, expert and data parallelism over ``torch.distributed``."""
