"""Training step, optimizer chain, schedules and state; the eval forward
and its metric pass; inference-time test modes."""
