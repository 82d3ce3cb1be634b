"""Flash-prefill attention kernel (Hopper CUDA port of the Pallas TPU kernel)."""
