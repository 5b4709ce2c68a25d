"""The PyTorch and CUDA port's benchmark harness (see README.md)."""
