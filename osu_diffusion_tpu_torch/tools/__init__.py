"""Measurement tools that run on a card (each a `python -m` entry point)."""
