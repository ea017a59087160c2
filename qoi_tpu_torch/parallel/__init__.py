"""Sequence-parallel codec on torch.distributed (port of qoi_tpu/parallel/)."""
