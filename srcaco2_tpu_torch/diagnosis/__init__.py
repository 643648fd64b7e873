"""The diagnosis studies, the reference `.pth` loader and onboarding kit,
the fold-manifest validator and the figures (port of srcaco2_tpu/diagnosis)."""
