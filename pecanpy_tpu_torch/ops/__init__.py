"""Device-side graph layout, samplers and the table applier (PyTorch/CUDA)."""
