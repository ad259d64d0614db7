"""CSR graphs and synthetic generators (host numpy, tensors on a device)."""
