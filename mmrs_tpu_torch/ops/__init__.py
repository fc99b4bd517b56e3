"""Ops with a plain PyTorch version and, on a CUDA tensor, a Hopper kernel."""
