"""Layers of the port (``paddle_tpu/nn/layer``): ``activation``,
``common``, ``container``, ``loss``, ``norm`` and ``transformer``."""
