"""The ports of the TPU probes of benchmarks/: scripts that time kernels
N (texgather), G at the in-row regroup's shape (regroup), P
(intersect_v1) and O (dyngather) on the card, each beside the PyTorch
calls that compute the same function; and ``compare``, which times P
and O beside another tree's build of their sources. Run one as
``python3 -m ptdn_tpu_torch.probes.<name>``; each needs one card."""
