"""Figures of trained experiments (port of parts of srcaco2_tpu/diagnosis)."""
