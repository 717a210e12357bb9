"""Kernels of the port (``csrc/``) with their wrappers and plain versions.

``ops.paged_attention`` is the module (its launch counters live there);
import the functions from it.
"""
