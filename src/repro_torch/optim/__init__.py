"""Optimizer and gradient compression of the LM substrate's training."""
