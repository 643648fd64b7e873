"""Inference-time modes of the port (training is not ported yet)."""
