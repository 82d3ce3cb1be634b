"""Mamba2 SSD chunked-scan kernel (Hopper CUDA port of the Pallas TPU kernel)."""
