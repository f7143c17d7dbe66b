"""The ports of the TPU probes of benchmarks/: scripts that time kernels
N (texgather), G at the in-row regroup's shape (regroup), P
(intersect_v1) and O (dyngather) on the card, each beside the PyTorch
calls that compute the same function. Run one as
``python3 -m ptdn_tpu_torch.probes.<name>``; each needs one card."""
