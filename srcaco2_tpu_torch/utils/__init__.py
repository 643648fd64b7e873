"""Logging, the metric tracker and the random-draw scheme."""
