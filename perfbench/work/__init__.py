"""The yardstick's arithmetic: the card's peaks, the bounds of kernels B1
and D from their work, kernel names, and the union of device intervals.
Frozen copies of the program's measurement code (ptdn_tpu_torch/utils/
card.py, bounce_bench.py:b1_work, chip_smoke.py's bound of D), which
later changes to the program cannot move."""
