"""Kernels of the port (``csrc/``) with their wrappers and plain versions,
and the fused linear-cross-entropy.

``ops.paged_attention`` (K4), ``ops.flash_attention`` (K1-K3) and
``ops.fused_adamw`` (K5) are the modules (their launch counters live
there); import the functions from them.
"""
