"""Chunk planning, metrics, run manifest, device selection and the CUDA
kernel library."""
