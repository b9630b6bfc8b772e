"""Interop with the reference's published artifacts (torch checkpoints)."""
