"""Tools of the port: tracer, showmap, merger, minimize, picker and the
lint, solve and descend tools (``python -m
killerbeez_tpu_torch.tools.<name>``), and diagnostics run on the card
(timing, kernel A/B, host profile)."""
