"""Diagnostics of the port (run on the card)."""
