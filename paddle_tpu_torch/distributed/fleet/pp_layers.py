"""The pipeline-parallel layer container
(``paddle_tpu/distributed/fleet/pp_layers.py``): ``LayerDesc``,
``SharedLayerDesc``, ``SegmentLayers`` and ``PipelineLayer``.

``SegmentLayers`` splits the descriptions as the JAX package's
``do_segment`` does (uniform, or balanced by a layer class's count or a
parameter-size estimate). The JAX package builds every stage in one
program; the port runs one process per rank, so on a ``pp`` mesh above
1 stage ``r`` (this rank's ``pp`` coordinate) builds only the entries of
its own segment: the others are None in ``run_funcs``. A model whose
trunk is a ``StackedPipelineBlocks`` is not segmented: every stage runs
the same entries and the stack holds this stage's rows
(``pipeline_schedule.py``).

A ``SharedLayerDesc`` key (tied embeddings) is built on every stage, its
parameters broadcast from the ``pp`` group's first rank, so the stages
that use it hold one weight; ``PipelineParallel`` sums their gradients
over the group after a batch (the reference's shared-weight all-reduce).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

import numpy as np

from ...nn.layer_base import Layer
from .. import topology

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer", "SegmentLayers"]


class LayerDesc:
    """reference: pp_layers.py:56: a layer built only by the stage that
    runs it."""

    def __init__(self, layer_func: Callable, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not callable(layer_func):
            raise TypeError("LayerDesc expects a Layer class or callable")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return (f"LayerDesc("
                f"{getattr(self.layer_func, '__name__', self.layer_func)})")


class SharedLayerDesc(LayerDesc):
    """reference: pp_layers.py:76: a layer several stages use (tied
    embeddings), one per ``key`` (module docstring)."""

    def __init__(self, key: str, layer_func: Callable, forward_func=None,
                 shared_weight_attr: str = "weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """reference: pp_layers.py:92: ``num_parts`` contiguous segments of
    the descriptions, uniform or balanced."""

    def __init__(self, layers_desc: Sequence, num_parts: int,
                 method: str = "uniform", num_virtual_pipeline_stage: int = 1):
        self.descs = list(layers_desc)
        self.num_parts = num_parts * num_virtual_pipeline_stage
        self.method = method
        if len(self.descs) < self.num_parts:
            raise ValueError(f"cannot split {len(self.descs)} layers into "
                             f"{self.num_parts} stages")

    def do_segment(self) -> List[int]:
        n, k = len(self.descs), self.num_parts
        if self.method == "uniform":
            return self._uniform(n, k)
        m = re.match(r"layer:(.+)", self.method)
        if m:
            cls_name = m.group(1)
            weights = [1 if getattr(d.layer_func, "__name__", "") == cls_name
                       or type(d).__name__ == cls_name else 0
                       for d in self.descs]
            return self._balance(weights, k)
        if self.method == "parameters":
            weights = []
            for d in self.descs:
                if isinstance(d, LayerDesc):
                    # estimated without building: the product of its int
                    # constructor arguments
                    weights.append(int(np.prod([v for v in d.inputs
                                                if isinstance(v, int)]) or 1))
                elif isinstance(d, Layer):
                    weights.append(sum(int(np.prod(p.shape))
                                       for p in d.parameters()))
                else:
                    weights.append(1)
            return self._balance(weights, k)
        raise ValueError(f"unknown seg_method {self.method}")

    @staticmethod
    def _uniform(n: int, k: int) -> List[int]:
        bounds = [0]
        base, rem = divmod(n, k)
        for i in range(k):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return bounds

    @staticmethod
    def _balance(weights: Sequence[int], k: int) -> List[int]:
        total = sum(weights) or 1
        target = total / k
        bounds, acc, taken = [0], 0.0, 0
        for i, w in enumerate(weights):
            acc += w
            if acc >= target * (taken + 1) and len(bounds) < k:
                bounds.append(i + 1)
                taken += 1
        while len(bounds) < k + 1:
            bounds.append(len(weights))
        bounds[-1] = len(weights)
        return bounds


def _call(f, x):
    return f(*x) if isinstance(x, tuple) else f(x)


class PipelineLayer(Layer):
    """reference: pp_layers.py:208 (module docstring): the descriptions,
    their segments over ``num_stages`` (default: the mesh's ``pp``
    degree), this stage's built entries and ``loss_fn``."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology_=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0,
                 num_virtual_pipeline_stages: int = 1, **kwargs):
        super().__init__()
        from .pipeline_schedule import StackedPipelineBlocks

        mesh = topology.get_mesh()
        if num_stages is None:
            num_stages = topology.axis_size("pp", mesh)
        self._num_stages = num_stages
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self.descs = list(layers)
        if any(isinstance(d, StackedPipelineBlocks) for d in self.descs):
            # the stack partitions its own rows over 'pp'
            self.segment_parts = [0, len(self.descs)]
        else:
            self.segment_parts = SegmentLayers(
                self.descs, num_stages, method=seg_method,
                num_virtual_pipeline_stage=num_virtual_pipeline_stages
            ).do_segment()
        self._stage = (mesh.coordinate()["pp"]
                       if num_stages > 1 and mesh is not None
                       and "pp" in mesh.axis_names else 0)
        lo, hi = ((0, len(self.descs)) if not self.segmented else
                  (self.segment_parts[self._stage],
                   self.segment_parts[self._stage + 1]))
        self._shared: dict = {}
        self.run_funcs: List = []
        built = 0  # sublayer names: the JAX package's index among built
        for i, d in enumerate(self.descs):
            mine = lo <= i < hi
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                layer, fwd = self._shared[d.layer_name], d.forward_func
                run = (lambda l, f: (lambda *xs: f(l, *xs) if f
                                     else l(*xs)))(layer, fwd)
            elif isinstance(d, LayerDesc):
                layer = run = d.build_layer() if mine else None
            elif isinstance(d, Layer):
                layer = run = d
            elif callable(d):
                self.run_funcs.append(d if mine else None)
                continue
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
            if mine:
                self.add_sublayer(str(built), layer)
            self.run_funcs.append(run if mine else None)
            built += 1
        if self._shared and self.segmented:
            self._sync_shared()

    @property
    def segmented(self) -> bool:
        """True when the stages run different entries (a ``pp`` mesh and
        no stacked trunk)."""
        return self._num_stages > 1 and len(self.segment_parts) > 2

    def pp_group(self):
        mesh = topology.get_mesh()
        return mesh.group("pp") if mesh is not None \
            and "pp" in mesh.axis_names else None

    def shared_parameters(self) -> list:
        return [p for layer in self._shared.values()
                for p in layer.parameters()]

    def _sync_shared(self) -> None:
        """Every stage's copy of a shared layer from the group's first
        rank (module docstring)."""
        from .. import collective

        group = self.pp_group()
        for p in self.shared_parameters():
            collective.broadcast(p, src=group.ranks[0], group=group)

    def get_num_stages(self) -> int:
        return self._num_stages

    def stage_layers(self, stage: int) -> List:
        """The entries stage ``stage`` runs (None where another rank
        built them)."""
        if stage >= self._num_stages or stage < 0:
            raise IndexError(f"stage {stage} out of range "
                             f"({self._num_stages} stages)")
        if not self.segmented:
            return list(self.run_funcs)
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return self.run_funcs[lo:hi]

    def stage_forward(self, x):
        """This stage's entries on ``x``."""
        for f in self.stage_layers(self._stage):
            x = _call(f, x)
        return x

    def forward(self, *args):
        x = args if len(args) > 1 else args[0]
        if not self.segmented:
            for f in self.run_funcs:
                x = _call(f, x)
            return x
        from .pipeline_schedule import pipeline_forward

        return pipeline_forward(self, x)
