"""Manifest-described, atomic checkpoints (single-device form)."""
