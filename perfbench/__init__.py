"""The benchmark of the PyTorch and CUDA port: harness, data, references."""
