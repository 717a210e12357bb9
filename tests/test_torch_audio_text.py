"""``paddle_tpu_torch.audio`` and ``paddle_tpu_torch.text`` against the
JAX package (the audio and text parts of ``tests/test_misc_families.py``).

The mel scales, filter bank, DCT basis and window are host tables of both
packages, equal to 1e-6; ``power_to_db`` and the feature layers agree at
rtol 1e-4 / atol 1e-4 (an STFT of 2,048 samples summed in another order,
then a log), Viterbi scores at 1e-5 and paths exactly, on the JAX test's
inputs and on a batch whose lengths leave padded tails. WAV files of
every bit depth the backend writes are written by the test and read by
both packages. JAX references are computed once per module.
"""
import itertools

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

SIG = np.random.default_rng(1).standard_normal((2, 2048)).astype("float32")
SIG1 = np.random.default_rng(2).standard_normal((1, 2048)).astype("float32")


def _np(t):
    return np.asarray(t.numpy())


def _audio(P):
    AF = P.audio.functional
    out = {
        "mel": [np.asarray([AF.hz_to_mel(440.0, h), AF.mel_to_hz(
            AF.hz_to_mel(440.0, h), h)]) for h in (False, True)],
        "mel_t": [_np(AF.hz_to_mel(P.to_tensor(np.array(
            [20.0, 440.0, 4000.0], "float32")))), _np(AF.mel_to_hz(
                P.to_tensor(np.array([1.0, 20.0, 40.0], "float32")), True))],
        "fbank": [_np(AF.compute_fbank_matrix(16000, 512, n_mels=40)),
                  _np(AF.compute_fbank_matrix(16000, 512, n_mels=40,
                                              htk=True, norm=2.0))],
        "freqs": [_np(AF.mel_frequencies(16)), _np(AF.fft_frequencies(
            16000, 64))],
        "db": [_np(AF.power_to_db(np.array([1.0, 10.0, 100.0], "float32"),
                                  top_db=None)),
               _np(AF.power_to_db(np.array([1e-12, 1.0, 1e4], "float32"),
                                  ref_value=2.0, top_db=30.0))],
        "dct": [_np(AF.create_dct(13, 32)), _np(AF.create_dct(8, 16,
                                                             norm=None))],
        "window": [_np(AF.get_window("hann", 64)),
                   _np(AF.get_window(("kaiser", 4.0), 32, fftbins=False))],
    }
    x = P.to_tensor(SIG)
    out["spec"] = [_np(P.audio.features.Spectrogram(n_fft=256)(x))]
    out["mel_spec"] = [_np(P.audio.features.MelSpectrogram(
        sr=16000, n_fft=256, n_mels=32)(x))]
    out["logmel"] = [_np(P.audio.features.LogMelSpectrogram(
        sr=16000, n_fft=256, hop_length=64, n_mels=32, top_db=80.0)(x))]
    out["mfcc"] = [_np(P.audio.features.MFCC(
        sr=16000, n_mfcc=13, n_fft=256, n_mels=32)(P.to_tensor(SIG1)))]
    return out


def _viterbi(P):
    rng = np.random.default_rng(3)
    pot = rng.standard_normal((2, 4, 5)).astype("float32")
    trans = rng.standard_normal((5, 5)).astype("float32")
    out = {"bruteforce": [pot, trans, np.array([4, 3], "int64"), True]}
    rng = np.random.default_rng(5)
    out["tails"] = [rng.standard_normal((6, 9, 7)).astype("float32"),
                    rng.standard_normal((7, 7)).astype("float32"),
                    np.array([9, 1, 4, 7, 2, 9], "int64"), True]
    out["no_bos_eos"] = [rng.standard_normal((3, 5, 4)).astype("float32"),
                         rng.standard_normal((4, 4)).astype("float32"),
                         np.array([5, 3, 1], "int64"), False]
    res = {}
    for k, (p, t, ln, bos) in out.items():
        s, path = P.text.viterbi_decode(p, t, ln, include_bos_eos_tag=bos)
        res[k] = [_np(s), _np(path)]
    dec = P.text.ViterbiDecoder(out["no_bos_eos"][1],
                                include_bos_eos_tag=False)
    s, path = dec(P.to_tensor(out["no_bos_eos"][0]),
                  P.to_tensor(out["no_bos_eos"][2]))
    res["layer"] = [_np(s), _np(path)]
    return res


@pytest.fixture(scope="module")
def jax_ref():
    return {"audio": _audio(pt), "viterbi": _viterbi(pt)}


AUDIO_CASES = ["mel", "mel_t", "fbank", "freqs", "db", "dct", "window",
               "spec", "mel_spec", "logmel", "mfcc"]


@pytest.mark.parametrize("case", AUDIO_CASES)
def test_audio_matches_the_jax_package(jax_ref, case):
    got = _audio(paddle)[case]
    tol = 1e-4 if case in ("spec", "mel_spec", "logmel", "mfcc") else 1e-6
    for g, w in zip(got, jax_ref["audio"][case]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_audio_layers_hold_the_jax_tests_checks():
    AF = paddle.audio.functional
    for htk in (False, True):
        np.testing.assert_allclose(AF.mel_to_hz(AF.hz_to_mel(440.0, htk),
                                                htk), 440.0, rtol=1e-4)
    fb = _np(AF.compute_fbank_matrix(16000, 512, n_mels=40))
    assert fb.shape == (40, 257) and (fb >= 0).all()
    assert (fb.sum(-1) > 0).all()
    mel = _np(paddle.audio.features.MelSpectrogram(
        sr=16000, n_fft=256, n_mels=32)(paddle.to_tensor(SIG)))
    assert mel.shape[:2] == (2, 32) and (mel >= 0).all()
    mfcc = paddle.audio.features.MFCC(sr=16000, n_mfcc=13, n_fft=256,
                                      n_mels=32)(paddle.to_tensor(SIG1))
    assert isinstance(mfcc, paddle.Tensor) and mfcc.shape[:2] == [1, 13]
    with pytest.raises(ValueError):
        paddle.audio.features.MFCC(n_mfcc=40, n_mels=32)
    with pytest.raises(ValueError):
        AF.power_to_db(np.ones(3, "float32"), amin=0.0)


@pytest.mark.parametrize("case", ["bruteforce", "tails", "no_bos_eos",
                                  "layer"])
def test_viterbi_matches_the_jax_package(jax_ref, case):
    got = _viterbi(paddle)[case]
    want = jax_ref["viterbi"][case]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])


def test_viterbi_matches_bruteforce_and_pads_with_the_last_tag():
    rng = np.random.default_rng(3)
    B, T, N = 2, 4, 5
    pot = rng.standard_normal((B, T, N)).astype("float32")
    trans = rng.standard_normal((N, N)).astype("float32")
    lens = np.array([4, 3], "int64")
    scores, paths = paddle.text.viterbi_decode(pot, trans, lens)
    for b in range(B):
        L = int(lens[b])
        best, best_path = -np.inf, None
        for cand in itertools.product(range(N), repeat=L):
            s = trans[N - 2, cand[0]] + pot[b, 0, cand[0]]
            for t in range(1, L):
                s += trans[cand[t - 1], cand[t]] + pot[b, t, cand[t]]
            s += trans[cand[-1], N - 1]
            if s > best:
                best, best_path = s, cand
        np.testing.assert_allclose(_np(scores)[b], best, rtol=1e-4)
        np.testing.assert_array_equal(_np(paths)[b][:L], best_path)
        assert (_np(paths)[b][L:] == best_path[-1]).all()


@pytest.mark.parametrize("make", [
    lambda P: P.text.datasets.Imdb(mode="train"),
    lambda P: P.text.Conll05st(),
    lambda P: P.audio.datasets.ESC50(),
    lambda P: P.audio.datasets.TESS(),
], ids=["imdb", "conll", "esc50", "tess"])
def test_datasets_raise_without_a_network(make):
    for P in (pt, paddle):
        with pytest.raises(RuntimeError, match="zero-egress"):
            make(P)


def test_audio_io_all_bit_depths_across_packages(tmp_path):
    """Each package writes every encoding and reads both files; info and
    samples agree, and a file written by either loads in the other."""
    sig = np.sin(np.linspace(0, 20 * np.pi, 2000)).astype(np.float32)
    stereo = np.stack([sig, 0.5 * sig])
    for enc, bits, tol in [("PCM_U", 8, 2e-2), ("PCM_S", 16, 1e-3),
                           ("PCM_S", 24, 1e-5), ("PCM_S", 32, 1e-6),
                           ("PCM_F", 32, 1e-7)]:
        paths = {}
        for P in (pt, paddle):
            paths[P] = str(tmp_path / f"{P.__name__}_{enc}_{bits}.wav")
            P.audio.save(paths[P], stereo, 16000, encoding=enc,
                         bits_per_sample=bits)
        assert open(paths[pt], "rb").read() == open(paths[paddle],
                                                    "rb").read()
        meta = paddle.audio.info(paths[pt])
        assert (meta.sample_rate, meta.num_channels, meta.bits_per_sample,
                meta.encoding) == (16000, 2, bits, enc)
        for path in paths.values():
            out, sr = paddle.audio.load(path)
            assert sr == 16000 and isinstance(out, paddle.Tensor)
            np.testing.assert_allclose(_np(out), stereo, atol=tol)
            want, _ = pt.audio.load(path)
            np.testing.assert_array_equal(_np(out), _np(want))


def test_audio_io_offset_frames_and_integer_input(tmp_path):
    from paddle_tpu_torch.audio.backends import wave_backend as wb

    sig = np.arange(100, dtype=np.float32)[None, :] / 200.0
    p = str(tmp_path / "o.wav")
    wb.save(p, sig, 8000, encoding="PCM_F", bits_per_sample=32)
    out, _ = wb.load(p, frame_offset=10, num_frames=5)
    np.testing.assert_allclose(_np(out), sig[:, 10:15], atol=1e-7)
    data = np.array([[1000, -2000, 30000]], dtype=np.int64)
    p = str(tmp_path / "i.wav")
    wb.save(p, data, 8000, bits_per_sample=16)
    assert wb.info(p).num_samples == 3
    out, _ = wb.load(p, normalize=False)
    np.testing.assert_array_equal(_np(out), data)
    assert wb.list_available_backends() == ["wave"]
    with pytest.raises(NotImplementedError):
        wb.set_backend("soundfile")
