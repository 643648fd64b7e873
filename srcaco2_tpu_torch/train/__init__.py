"""Training step, optimizer chain, schedules and state; inference-time
test modes."""
