"""``paddle_tpu_torch.fft`` and ``paddle_tpu_torch.signal`` against the
JAX package (``tests/test_fft_signal.py``'s cases, each run through both
packages on the same inputs).

Every case's JAX outputs are computed once, in a module fixture. Values
agree with the JAX package's at rtol 1e-5 / atol 1e-5 in f32 (at 1e-4
where the JAX test itself allows it: the transforms sum in another
order), complex128 and float64 ones at 1e-12, and each case keeps the JAX
test's own check against numpy/scipy. Errors are the same exception
types. Real-input gradients agree within 1e-6; a complex leaf's gradient
is the conjugate of the JAX package's (torch's convention), held as such.
"""
import numpy as np
import pytest
import scipy.fft as sft
import scipy.signal as sps

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

X = np.random.default_rng(0).standard_normal(16).astype("float32")
X2 = np.random.default_rng(1).standard_normal((4, 8)).astype("float32")
RNG9 = np.random.default_rng(9)
XC = (RNG9.standard_normal((4, 5))
      + 1j * RNG9.standard_normal((4, 5))).astype("complex64")
XR = RNG9.standard_normal((4, 5)).astype("float32")
WIN = np.hanning(64).astype("float32")
SIG = np.random.default_rng(3).standard_normal(256).astype("float32")
SIG4 = np.random.default_rng(4).standard_normal(400).astype("float32")


def _np(t):
    return np.asarray(t.numpy())


def _cases():
    return {
        "fft_ifft": lambda P: [P.fft.fft(X), P.fft.ifft(P.fft.fft(X))],
        "rfft_irfft": lambda P: [P.fft.rfft(X),
                                 P.fft.irfft(P.fft.rfft(X))],
        "hfft_ihfft": lambda P: [P.fft.ihfft(X),
                                 P.fft.hfft(P.fft.ihfft(X))],
        "norms": lambda P: [P.fft.fft(X, norm=n)
                            for n in ("backward", "ortho", "forward")],
        "2d_nd": lambda P: [P.fft.fft2(X2), P.fft.rfft2(X2), P.fft.fftn(X2),
                            P.fft.irfftn(P.fft.rfftn(X2)),
                            P.fft.ifft2(X2), P.fft.irfft2(P.fft.rfft2(X2)),
                            P.fft.ifftn(X2), P.fft.ihfft2(XR)],
        "f64": lambda P: [P.fft.fft(X.astype("float64")),
                          P.fft.rfftn(X2.astype("float64"))],
        "freq_shift": lambda P: [P.fft.fftfreq(8, d=0.5), P.fft.rfftfreq(8),
                                 P.fft.fftshift(X),
                                 P.fft.ifftshift(P.fft.fftshift(X)),
                                 P.fft.fftshift(X2, axes=(1,))],
        "hfftn": lambda P: [P.fft.hfftn(XC), P.fft.ihfftn(XR),
                            P.fft.hfft2(XC)],
        "frame": lambda P: [P.signal.frame(np.arange(8, dtype="float32"),
                                           4, 2)],
        "frame_axis0_batch": lambda P: [
            P.signal.frame(np.arange(8, dtype="float32"), 4, 2, axis=0),
            P.signal.frame(np.stack([np.arange(8, dtype="float32")] * 2),
                           4, 2)],
        "overlap_add_inverts": lambda P: [P.signal.overlap_add(
            P.signal.frame(X, frame_length=4, hop_length=4), hop_length=4)],
        "overlap_add_sums": lambda P: [P.signal.overlap_add(
            np.ones((4, 3), "float32"), hop_length=2)],
        "overlap_add_axis0": lambda P: [P.signal.overlap_add(
            np.random.default_rng(10).standard_normal((3, 4, 2)).astype(
                "float32"), hop_length=2, axis=0)],
        "stft": lambda P: [P.signal.stft(SIG, n_fft=64, hop_length=16,
                                         window=WIN, center=True)],
        "stft_istft": lambda P: [P.signal.istft(
            P.signal.stft(SIG4, n_fft=64, hop_length=16, window=WIN),
            n_fft=64, hop_length=16, window=WIN, length=len(SIG4))],
        "stft_options": lambda P: [
            P.signal.stft(SIG[None], n_fft=64, hop_length=16,
                          win_length=48, window=WIN[:48], normalized=True),
            P.signal.stft(SIG, n_fft=32, center=False),
            P.signal.stft(XC.reshape(-1), n_fft=8, onesided=False)],
    }


@pytest.fixture(scope="module")
def jax_ref():
    return {k: [_np(t) for t in fn(pt)] for k, fn in _cases().items()}


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype in (np.float64, np.complex128):
        tol = 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_case_matches_the_jax_package(jax_ref, case):
    got = [_np(t) for t in _cases()[case](paddle)]
    assert len(got) == len(jax_ref[case])
    for g, w in zip(got, jax_ref[case]):
        _close(g, w, 1e-4 if case in ("2d_nd", "hfftn", "stft",
                                      "stft_options") else 1e-5)


def test_fft_against_numpy():
    y = paddle.fft.fft(X)
    np.testing.assert_allclose(_np(y), np.fft.fft(X), rtol=1e-4)
    np.testing.assert_allclose(_np(paddle.fft.ifft(y)).real, X, atol=1e-5)
    np.testing.assert_allclose(_np(paddle.fft.rfft(X)), np.fft.rfft(X),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(paddle.fft.ihfft(X)), np.fft.ihfft(X),
                               rtol=1e-4, atol=1e-6)
    for norm in ("backward", "ortho", "forward"):
        np.testing.assert_allclose(_np(paddle.fft.fft(X, norm=norm)),
                                   np.fft.fft(X, norm=norm), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(paddle.fft.fft2(X2)), np.fft.fft2(X2),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(paddle.fft.fftfreq(8, d=0.5)),
                               np.fft.fftfreq(8, d=0.5), rtol=1e-6)
    np.testing.assert_allclose(_np(paddle.fft.hfftn(XC)), sft.hfftn(XC),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(paddle.fft.ihfftn(XR)), sft.ihfftn(XR),
                               rtol=1e-3, atol=1e-5)


def test_signal_against_numpy_and_scipy():
    x = np.arange(8, dtype="float32")
    f = _np(paddle.signal.frame(x, frame_length=4, hop_length=2))
    assert f.shape == (4, 3)
    np.testing.assert_allclose(f[:, 1], x[2:6])
    assert _np(paddle.signal.frame(x, 4, 2, axis=0)).shape == (3, 4)
    np.testing.assert_allclose(_np(paddle.signal.overlap_add(
        np.ones((4, 3), "float32"), hop_length=2)), [1, 1, 2, 2, 2, 2, 1, 1])
    got = _np(paddle.signal.stft(SIG, n_fft=64, hop_length=16, window=WIN))
    _, _, ref = sps.stft(SIG, nperseg=64, noverlap=48, window=WIN,
                         boundary="even", padded=False, return_onesided=True)
    n = min(got.shape[-1], ref.shape[-1])
    np.testing.assert_allclose(got[:, :n], (ref * WIN.sum())[:, :n],
                               atol=1e-3)
    back = _np(paddle.signal.istft(paddle.signal.stft(
        SIG4, n_fft=64, hop_length=16, window=WIN), n_fft=64, hop_length=16,
        window=WIN, length=len(SIG4)))
    np.testing.assert_allclose(back, SIG4, atol=1e-4)


@pytest.mark.parametrize("call", [
    lambda P: P.fft.fft(X, norm="bogus"),
    lambda P: P.signal.frame(np.arange(8, dtype="float32"),
                             frame_length=9, hop_length=1),
    lambda P: P.signal.frame(np.arange(8, dtype="float32"),
                             frame_length=4, hop_length=0),
    lambda P: P.signal.overlap_add(np.ones((4, 3), "float32"),
                                   hop_length=-1),
    lambda P: P.signal.stft(np.ones(64, "complex64"), n_fft=16),
], ids=["norm", "frame_long", "frame_hop", "overlap_hop", "stft_complex"])
def test_errors_are_the_jax_packages(call):
    with pytest.raises(Exception) as want:
        call(pt)
    with pytest.raises(Exception) as got:
        call(paddle)
    assert type(got.value) is type(want.value) is ValueError


def test_name_kwarg_is_taken():
    x = np.ones(8, "float32")
    for P in (pt, paddle):
        P.fft.fft(x, name="n")
        P.fft.fftn(x, name="n")


def _real_grads(P):
    out = []
    for fn in (lambda x: P.fft.rfft(x), lambda x: P.fft.fft(x),
               lambda x: P.fft.fft2(x.reshape([4, 4]), norm="ortho"),
               lambda x: P.fft.ihfft(x)):
        x = P.to_tensor(X, stop_gradient=False)
        y = fn(x)
        loss = (P.abs(y) ** 2).sum() + P.real(y).sum()
        loss.backward()
        out.append(_np(x.grad))
    sig = P.to_tensor(SIG, stop_gradient=False)
    spec = P.signal.stft(sig, n_fft=64, hop_length=16, window=WIN)
    (P.abs(spec) ** 2).sum().backward()
    out.append(_np(sig.grad))
    return out


def test_real_input_gradients_match():
    for g, w in zip(_real_grads(paddle), _real_grads(pt)):
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * max(
            1.0, np.abs(w).max()))


def test_complex_leaf_gradient_is_the_conjugate_of_jax():
    """d Re(z * (2+3i)) / dz at z = 1+i: 2+3i in JAX, 2-3i in torch
    (ROADMAP Queue 3, differences by design); through an fft as well."""
    grads = {}
    for P in (pt, paddle):
        z = P.to_tensor(np.array([1 + 1j], "complex64"), stop_gradient=False)
        c = P.to_tensor(np.array([2 + 3j], "complex64"))
        P.real(z * c).sum().backward()
        w = P.to_tensor(XC.reshape(-1)[:8], stop_gradient=False)
        P.real(P.fft.fft(w) * c).sum().backward()
        grads[P] = (_np(z.grad), _np(w.grad))
    np.testing.assert_allclose(grads[pt][0], [2 + 3j])
    np.testing.assert_allclose(grads[paddle][0], [2 - 3j])
    np.testing.assert_allclose(grads[paddle][1], np.conj(grads[pt][1]),
                               rtol=1e-5, atol=1e-5)
