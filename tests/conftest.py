import os
import sys

# tests see ONE device (the dry-run's 512-device override is local to
# launch/dryrun.py, never global)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels have "
        "no CPU mode); such tests skip without one")
