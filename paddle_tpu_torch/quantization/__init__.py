"""paddle_tpu_torch.quantization: the KV-page quantizer of the serving
engine (``observers.py``), counterpart of ``paddle_tpu/quantization``'s
KV helpers."""
from .observers import (KV_QMAX, KV_SCALE_FLOOR, dequantize_kv,
                        kv_absmax_scales, quantize_kv)

__all__ = ["KV_QMAX", "KV_SCALE_FLOOR", "kv_absmax_scales", "quantize_kv",
           "dequantize_kv"]
