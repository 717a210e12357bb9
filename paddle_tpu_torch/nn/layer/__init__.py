"""Layers of the port (``paddle_tpu/nn/layer``): ``activation``,
``common``, ``container``, ``conv``, ``loss``, ``norm``, ``pooling``,
``rnn`` and ``transformer``."""
