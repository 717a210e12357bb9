"""``paddle.signal`` (``paddle_tpu/signal.py``): ``frame``,
``overlap_add``, ``stft`` and ``istft`` as ops of the tape.

The JAX package frames with a gather and overlaps with a scatter-add; the
port frames with ``Tensor.unfold`` (a strided view) and overlaps with
``index_add`` over the flattened frame positions, and transforms with
``torch.fft``. The layouts, defaults and errors are the JAX package's: a
window shorter than ``n_fft`` is centred in it, ``center`` pads by
``n_fft // 2`` with ``pad_mode``, ``istft`` divides by the window
envelope (clamped at 1e-11), a one-sided ``stft`` of complex input
raises ``ValueError``.
"""
from __future__ import annotations

import torch

from .ops._apply import ensure_tensor, unary

__all__ = ["frame", "overlap_add", "stft", "istft"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "replicate": "replicate",
              "circular": "circular"}


def frame(x, frame_length: int, hop_length: int, axis: int = -1, name=None):
    """``paddle.signal.frame``: a window of ``frame_length`` every
    ``hop_length`` samples; ``axis=-1`` gives ``[..., frame_length,
    num_frames]``, ``axis=0`` ``[num_frames, frame_length, ...]``."""
    if hop_length <= 0:
        raise ValueError(f"hop_length should be > 0, got {hop_length}")
    xt = ensure_tensor(x)
    n = int(xt.shape[axis])
    if not 0 < frame_length <= n:
        raise ValueError(
            f"frame_length should be in (0, {n}], got {frame_length}")

    def f(a):
        g = a.unfold(axis, frame_length, hop_length)  # frames at axis, L last
        if axis == 0:
            return g.movedim(-1, 1)  # [F, L, ...]
        return g.transpose(-1, -2)  # [..., L, F]

    return unary(f, xt, name="frame")


def _overlap(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum frames ``[..., F, L]`` at ``hop`` strides: ``[..., (F-1)*hop +
    L]``."""
    F, L = frames.shape[-2], frames.shape[-1]
    n_out = (F - 1) * hop + L
    idx = (torch.arange(F, device=frames.device) * hop)[:, None] \
        + torch.arange(L, device=frames.device)[None, :]
    out = torch.zeros(frames.shape[:-2] + (n_out,), dtype=frames.dtype,
                      device=frames.device)
    return out.index_add(-1, idx.reshape(-1),
                         frames.reshape(frames.shape[:-2] + (F * L,)))


def overlap_add(x, hop_length: int, axis: int = -1, name=None):
    """``paddle.signal.overlap_add``: the inverse of :func:`frame`, frames
    summed at ``hop_length`` strides."""
    if hop_length <= 0:
        raise ValueError(f"hop_length should be > 0, got {hop_length}")
    xt = ensure_tensor(x)

    def f(a):
        if axis in (-1, a.ndim - 1) and axis != 0:
            frames = a.transpose(-1, -2)  # [..., F, L]
        elif a.ndim > 2:
            frames = a.movedim((0, 1), (-2, -1))  # [F, L, ...] -> [..., F, L]
        else:
            frames = a  # 2-D [F, L]
        out = _overlap(frames, hop_length)
        if axis == 0 and a.ndim > 2:
            out = out.movedim(-1, 0)
        return out

    return unary(f, xt, name="overlap_add")


def _window(window, win_length: int, n_fft: int, ref: torch.Tensor):
    if window is not None:
        w = ensure_tensor(window)._value.to(ref.device)
    else:
        w = torch.ones((win_length,), dtype=torch.float32, device=ref.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = torch.nn.functional.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft(x, n_fft: int, hop_length=None, win_length=None, window=None,
         center: bool = True, pad_mode: str = "reflect",
         normalized: bool = False, onesided: bool = True, name=None):
    """``paddle.signal.stft``: ``x`` ``[B, T]`` or ``[T]`` real (complex
    only with ``onesided=False``); returns ``[B, n_fft//2+1 or n_fft,
    num_frames]`` complex."""
    xt = ensure_tensor(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if xt._value.is_complex() and onesided:
        raise ValueError(
            "stft with a complex input requires onesided=False "
            "(reference contract: onesided spectra are for real input)")
    w = _window(window, win_length, n_fft, xt._value)

    def f(a):
        was_1d = a.ndim == 1
        if was_1d:
            a = a[None]
        if center:
            pad = n_fft // 2
            a = torch.nn.functional.pad(a, (pad, pad),
                                        mode=_PAD_MODES[pad_mode])
        frames = a.unfold(-1, n_fft, hop_length) * w  # [B, F, n_fft]
        spec = (torch.fft.rfft(frames, dim=-1) if onesided
                else torch.fft.fft(frames, dim=-1))
        if normalized:
            spec = spec / float(n_fft) ** 0.5
        out = spec.transpose(-1, -2)  # [B, bins, F]
        return out[0] if was_1d else out

    return unary(f, xt, name="stft")


def istft(x, n_fft: int, hop_length=None, win_length=None, window=None,
          center: bool = True, normalized: bool = False,
          onesided: bool = True, length=None, return_complex: bool = False,
          name=None):
    """``paddle.signal.istft``: the inverse STFT with the window-envelope
    normalization (NOLA)."""
    xt = ensure_tensor(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    w = _window(window, win_length, n_fft, xt._value)

    def f(a):
        was_2d = a.ndim == 2
        if was_2d:
            a = a[None]
        spec = a.transpose(-1, -2)  # [B, F, bins]
        if normalized:
            spec = spec * float(n_fft) ** 0.5
        frames = (torch.fft.irfft(spec, n=n_fft, dim=-1) if onesided
                  else torch.fft.ifft(spec, dim=-1))
        if not return_complex and frames.is_complex():
            frames = frames.real
        frames = frames * w  # [B, F, n_fft]
        F = frames.shape[-2]
        out = _overlap(frames, hop_length)
        env = _overlap((w * w).expand(F, n_fft), hop_length)
        out = out / torch.clamp(env, min=1e-11)
        if center:
            pad = n_fft // 2
            out = out[..., pad:out.shape[-1] - pad]
        if length is not None:
            out = out[..., :length]
        return out[0] if was_2d else out

    return unary(f, xt, name="istft")
