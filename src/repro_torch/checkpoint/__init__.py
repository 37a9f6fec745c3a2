"""Checkpoints of tensor trees (``repro_torch.checkpoint.checkpointer``)."""
