"""Distributed training of the port (``paddle_tpu/distributed``): so far
only ``fleet.recompute``, which runs on one card."""
