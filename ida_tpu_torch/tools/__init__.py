"""Measurement scripts for the card (run from the repository root)."""
