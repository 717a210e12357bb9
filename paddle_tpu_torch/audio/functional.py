"""Audio frequency-domain helpers (``paddle_tpu/audio/functional.py``):
the mel scales, ``compute_fbank_matrix``, ``power_to_db``, ``create_dct``
and ``get_window``. The tables are computed on the host in float64 numpy,
as the JAX package computes them, and become Tensors on the default
device; ``power_to_db`` is an op of the tape."""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..ops._apply import ensure_tensor, unary
from ..tensor import Tensor

__all__ = [
    "hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
    "compute_fbank_matrix", "power_to_db", "create_dct", "get_window",
]


def hz_to_mel(freq, htk: bool = False):
    """reference: functional.py hz_to_mel (slaney default)."""
    scalar = not isinstance(freq, Tensor)
    f = np.asarray(freq.numpy()) if isinstance(freq, Tensor) \
        else np.asarray(freq, "float64")
    if htk:
        mel = 2595.0 * np.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        mel = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        mel = np.where(f >= min_log_hz,
                       min_log_mel + np.log(np.maximum(f, 1e-10)
                                            / min_log_hz) / logstep, mel)
    return float(mel) if scalar and mel.ndim == 0 else Tensor(
        mel.astype("float32"), stop_gradient=True)


def mel_to_hz(mel, htk: bool = False):
    """reference: functional.py mel_to_hz."""
    scalar = not isinstance(mel, Tensor)
    m = np.asarray(mel.numpy()) if isinstance(mel, Tensor) \
        else np.asarray(mel, "float64")
    if htk:
        f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        f = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        f = np.where(m >= min_log_mel,
                     min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return float(f) if scalar and f.ndim == 0 else Tensor(
        f.astype("float32"), stop_gradient=True)


def mel_frequencies(n_mels: int = 64, f_min: float = 0.0,
                    f_max: float = 11025.0, htk: bool = False,
                    dtype="float32"):
    """reference: functional.py mel_frequencies."""
    lo, hi = hz_to_mel(f_min, htk), hz_to_mel(f_max, htk)
    mels = np.linspace(lo, hi, n_mels)
    f = np.asarray(mel_to_hz(Tensor(mels.astype("float32")), htk).numpy())
    return Tensor(f.astype(dtype), stop_gradient=True)


def fft_frequencies(sr: int, n_fft: int, dtype="float32"):
    """reference: functional.py fft_frequencies."""
    return Tensor(np.linspace(0, sr / 2, 1 + n_fft // 2).astype(dtype),
                  stop_gradient=True)


def compute_fbank_matrix(sr: int, n_fft: int, n_mels: int = 64,
                         f_min: float = 0.0, f_max: Optional[float] = None,
                         htk: bool = False, norm: Union[str, float] = "slaney",
                         dtype="float32"):
    """reference: functional.py compute_fbank_matrix — [n_mels, 1+n_fft//2]
    triangular mel filter bank."""
    f_max = f_max or sr / 2.0
    fft_f = np.asarray(fft_frequencies(sr, n_fft, "float64").numpy())
    mel_f = np.asarray(mel_frequencies(n_mels + 2, f_min, f_max, htk,
                                       "float64").numpy())
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    weights = np.zeros((n_mels, len(fft_f)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif isinstance(norm, (int, float)):
        w_norm = np.linalg.norm(weights, ord=norm, axis=-1, keepdims=True)
        weights = weights / np.maximum(w_norm, 1e-10)
    return Tensor(weights.astype(dtype), stop_gradient=True)


def power_to_db(spect, ref_value: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0, name=None):
    """reference: functional.py power_to_db — 10*log10 with top_db floor."""
    if amin <= 0:
        raise ValueError("amin must be strictly positive")
    if ref_value <= 0:
        raise ValueError("ref_value must be strictly positive")

    if top_db is not None and top_db < 0:
        raise ValueError("top_db must be non-negative")

    def fn(s):
        log_spec = 10.0 * torch.log10(torch.clamp(s, min=amin))
        log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
        if top_db is not None:
            log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
        return log_spec

    return unary(fn, ensure_tensor(spect), name="power_to_db")


def create_dct(n_mfcc: int, n_mels: int, norm: Optional[str] = "ortho",
               dtype="float32"):
    """reference: functional.py create_dct — [n_mels, n_mfcc] DCT-II basis."""
    n = np.arange(n_mels, dtype="float64")
    k = np.arange(n_mfcc, dtype="float64")[None, :]
    dct = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k)
    if norm == "ortho":
        dct[:, 0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return Tensor(dct.astype(dtype), stop_gradient=True)


def get_window(window: Union[str, tuple], win_length: int,
               fftbins: bool = True, dtype="float32"):
    """reference: audio/functional/window.py get_window."""
    import scipy.signal as sps

    w = sps.get_window(window, win_length, fftbins=fftbins)
    return Tensor(w.astype(dtype), stop_gradient=True)
