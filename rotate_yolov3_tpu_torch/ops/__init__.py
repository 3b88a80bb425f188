"""Top-k, rotated-box geometry, rotated NMS and the CUDA kernel wrappers."""
