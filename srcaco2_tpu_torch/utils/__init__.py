"""Logging, the metric tracker, the random-draw scheme, the cluster
helpers, profiling hooks and the reference's image helpers."""
