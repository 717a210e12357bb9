"""``paddle.audio`` (``paddle_tpu/audio/``): ``functional`` (the mel
scales, ``compute_fbank_matrix``, ``power_to_db``, ``create_dct``,
``get_window``), ``features`` (``Spectrogram``, ``MelSpectrogram``,
``LogMelSpectrogram``, ``MFCC`` layers over ``signal.stft``), the stdlib
WAV backend and the datasets, which raise without a network.
"""
from . import backends, datasets, features, functional  # noqa: F401
from .backends import info, load, save  # noqa: F401

__all__ = ["features", "functional", "backends", "datasets",
           "load", "info", "save"]
