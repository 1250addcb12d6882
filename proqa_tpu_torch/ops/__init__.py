"""Search and attention ops; each CUDA kernel sits beside its plain PyTorch version."""
