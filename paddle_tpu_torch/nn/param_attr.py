"""``ParamAttr``: how a Layer makes one parameter (``paddle_tpu/nn/param_attr.py``).

Its name, initializer, learning-rate multiplier, regularizer and
``trainable`` flag reach the Parameter ``Layer.create_parameter`` makes.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer=None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        do_model_average: bool = True,
        need_clip: bool = True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """Normalize {None, False, str, Initializer, ParamAttr} → ParamAttr|False|None
        (reference: ParamAttr._to_attr)."""
        if attr is None:
            return None
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        # an Initializer instance
        return ParamAttr(initializer=attr)
