"""Tools of the port: tracer and showmap (``python -m
killerbeez_tpu_torch.tools.<name>``) and diagnostics run on the card
(timing, kernel A/B, host profile)."""
