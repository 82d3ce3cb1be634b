"""Token-bucket shaper kernel (Hopper CUDA port of the Pallas TPU kernel)."""
