"""Data parallelism over torch.distributed (port of srcaco2_tpu/parallel)."""
