"""``audio.datasets`` (``paddle_tpu/audio/datasets/``): ESC50 and TESS
download their corpora, so without a network their constructors raise
with the local-files recipe, as the text datasets do."""
__all__ = ["ESC50", "TESS"]


class _ZeroEgressAudioDataset:
    def __init__(self, *a, **k):
        raise RuntimeError(
            f"{type(self).__name__} downloads its corpus from the network; "
            "this environment is zero-egress. Provide local WAV files and "
            "wrap them with paddle_tpu_torch.io.Dataset + "
            "audio.backends.load.")


class ESC50(_ZeroEgressAudioDataset):
    pass


class TESS(_ZeroEgressAudioDataset):
    pass
