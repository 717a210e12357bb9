"""``paddle.version`` (``paddle_tpu/version.py``) of the port's build:
``cuda()`` and ``cudnn()`` report torch's CUDA and cuDNN versions (or
``"False"`` without them), where the JAX package's TPU build says
``"False"``."""
import torch

full_version = "3.0.0-cuda"
major = "3"
minor = "0"
patch = "0"
rc = "0"
commit = "torch-cuda"
istaged = True

__all__ = ["full_version", "major", "minor", "patch", "rc", "commit",
           "show", "cuda", "cudnn", "xpu"]


def show() -> None:
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"commit: {commit}")
    print(f"cuda: {cuda()}")
    print(f"cudnn: {cudnn()}")


def cuda() -> str:
    return str(torch.version.cuda) if torch.version.cuda else "False"


def cudnn() -> str:
    v = torch.backends.cudnn.version() if torch.version.cuda else None
    return str(v) if v else "False"


def xpu() -> str:
    return "False"
