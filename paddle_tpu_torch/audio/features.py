"""Audio feature layers (``paddle_tpu/audio/features.py``):
``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram`` and ``MFCC`` as
facade ``Layer``s over ``signal.stft``; the window, the mel filter bank
and the DCT basis are Tensors on the default device, built at
construction."""
from __future__ import annotations

from typing import Optional, Union

from .. import ops
from ..nn.layer_base import Layer
from ..ops._apply import ensure_tensor
from ..signal import stft
from . import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    """reference: features/layers.py Spectrogram — |STFT|^power."""

    def __init__(self, n_fft: int = 512, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", dtype: str = "float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.fft_window = AF.get_window(window, self.win_length, dtype=dtype)

    def forward(self, x):
        spec = stft(ensure_tensor(x), n_fft=self.n_fft,
                    hop_length=self.hop_length, win_length=self.win_length,
                    window=self.fft_window, center=self.center,
                    pad_mode=self.pad_mode)
        mag = ops.abs(spec)
        if self.power != 1.0:
            mag = mag ** self.power
        return mag


class MelSpectrogram(Layer):
    """reference: features/layers.py MelSpectrogram."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 dtype: str = "float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        dtype)
        self.fbank_matrix = AF.compute_fbank_matrix(
            sr=sr, n_fft=n_fft, n_mels=n_mels, f_min=f_min, f_max=f_max,
            htk=htk, norm=norm, dtype=dtype)

    def forward(self, x):
        spec = self._spectrogram(x)  # [..., bins, frames]
        return ops.matmul(self.fbank_matrix, spec)


class LogMelSpectrogram(Layer):
    """reference: features/layers.py LogMelSpectrogram."""

    def __init__(self, sr: int = 22050, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 ref_value: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None, dtype: str = "float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        mel = self._melspectrogram(x)
        return AF.power_to_db(mel, ref_value=self.ref_value, amin=self.amin,
                              top_db=self.top_db)


class MFCC(Layer):
    """reference: features/layers.py MFCC — DCT over log-mel."""

    def __init__(self, sr: int = 22050, n_mfcc: int = 40, n_fft: int = 512,
                 hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: str = "hann",
                 power: float = 2.0, center: bool = True,
                 pad_mode: str = "reflect", n_mels: int = 64,
                 f_min: float = 50.0, f_max: Optional[float] = None,
                 htk: bool = False, norm: Union[str, float] = "slaney",
                 ref_value: float = 1.0, amin: float = 1e-10,
                 top_db: Optional[float] = None, dtype: str = "float32"):
        super().__init__()
        if n_mfcc > n_mels:
            raise ValueError("n_mfcc cannot be larger than n_mels")
        self._log_melspectrogram = LogMelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, ref_value, amin,
            top_db, dtype)
        self.dct_matrix = AF.create_dct(n_mfcc, n_mels, dtype=dtype)

    def forward(self, x):
        logmel = self._log_melspectrogram(x)  # [..., n_mels, frames]
        return ops.matmul(ops.t(self.dct_matrix), logmel)
