"""Layers of the port (``paddle_tpu/nn/layer``)."""
