"""Losses of the training step: MasterLoss and its terms (master.py),
their operators (ops.py) and the extended log-barrier (elb.py)."""
