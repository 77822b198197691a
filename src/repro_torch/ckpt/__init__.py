"""Fault-tolerant checkpointing (atomic, keep-K, async) on PyTorch, in the
reference package's on-disk format."""

from repro_torch.ckpt import checkpoint  # noqa: F401
