"""``Linear`` and ``Embedding`` (``paddle_tpu/nn/layer/common.py``).

``torch.nn`` storage (a Linear weight is ``[out, in]``; the JAX
package's is ``[in, out]``, which ``models/convert.py`` transposes), with
forwards that go through the port's functionals and so through the amp
cast rule.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding"]


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Embedding):
    def forward(self, ids):
        return F.embedding(ids, self.weight)
