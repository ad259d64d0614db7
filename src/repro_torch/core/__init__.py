"""Fused BPT sampling, tile layout and IMM seed selection (PyTorch)."""
