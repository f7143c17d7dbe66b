"""The benchmark of ptdn_tpu_torch on an NVIDIA card (README.md)."""
