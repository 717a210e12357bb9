"""PS-backed layers for eager training (``paddle_tpu/distributed/ps/layers.py``).

Reference parity: ``paddle.static.nn.sparse_embedding`` (the PS-routed
embedding lookup the reference lowers to ``pull_sparse`` /
``push_sparse`` ops, ``python/paddle/static/nn/common.py``). On torch
autograd: the lookup pulls the rows of the flat ids (duplicates
included) from the servers, stages them in a pinned host buffer and
moves them to the layer's device in one copy, as a leaf that requires
grad; a hook on that leaf pushes the per-lookup row gradients back as
f32 numpy (the servers apply their optimizer; duplicate ids are applied
in sequence by the table), or hands them to a communicator. The table
never takes device memory and the dense trunk trains on the card.
``stats`` counts the pulls and pushes, their rows and their host
seconds (a pull with its staging and copy to the device; a push with its
copy to the host, which waits for the backward so far).

The pull is a host round trip, so a step with a ``SparseEmbedding``
cannot be captured as a CUDA graph: a replay would reuse the captured
pull. ``jit.StaticFunction`` refuses such a step with a RuntimeError
(``__jit_capture__``); it runs eagerly. The hook's device-to-host copy
synchronises the stream inside the backward, by design.
"""
from __future__ import annotations

from typing import Optional

import time

import numpy as np
import torch

from ...device import resolve_device
from ...nn.layer_base import Layer
from ...tensor import Tensor
from .service import PSClient
from .table import TableConfig

__all__ = ["SparseEmbedding"]


class SparseEmbedding(Layer):
    """Host-resident embedding table behind a :class:`PSClient`.

    Rows are created on first touch (no vocab-size cap, like the
    reference's grow-on-demand sparse tables: ids are uint64 hashes).
    The layer holds no device parameters: the "parameter" lives on the
    servers, updated by the server-side optimizer on every ``backward``.
    ``device`` is where the rows go (the card unless told otherwise).
    Given a torch tensor of ids it returns a torch tensor; given a
    facade ``Tensor`` or an array, a facade ``Tensor``.
    """

    def __init__(self, client: PSClient, table_id: int,
                 embedding_dim: int,
                 config: Optional[TableConfig] = None,
                 name: Optional[str] = None,
                 communicator=None, device=None):
        super().__init__()
        cfg = config or TableConfig(dim=embedding_dim)
        if cfg.dim != embedding_dim:
            raise ValueError(f"TableConfig.dim={cfg.dim} != "
                             f"embedding_dim={embedding_dim}")
        self._client = client
        self._table_id = table_id
        self._dim = embedding_dim
        self._device = resolve_device(device)
        # async mode (reference: Communicator async): grads accumulate in
        # the communicator and flush on its schedule instead of blocking
        # the backward pass on a server round trip
        self._communicator = communicator
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None
        self.stats = {"pulls": 0, "rows_pulled": 0, "pull_s": 0.0,
                      "pushes": 0, "rows_pushed": 0, "push_s": 0.0}
        client.create_sparse_table(table_id, cfg)

    def __jit_capture__(self):
        return ("refuse", "SparseEmbedding pulls its rows from the "
                "parameter servers on the host at every call, and a CUDA "
                "graph would replay the captured pull; run this step "
                "eagerly")

    def _to_device(self, rows_np: np.ndarray) -> torch.Tensor:
        """``rows_np`` on the layer's device: through a pinned staging
        buffer and one host-to-device copy on the card."""
        host = torch.from_numpy(rows_np)
        if self._device.type != "cuda":
            return host
        n = host.numel()
        if self._staging is None or self._staging.numel() < n:
            self._staging = torch.empty(n, dtype=torch.float32,
                                        pin_memory=True)
            self._copied = torch.cuda.Event()
        else:  # the last copy out of the buffer must have finished
            self._copied.synchronize()
        stage = self._staging[:n].view(host.shape)
        stage.copy_(host)
        rows = stage.to(self._device, non_blocking=True)
        self._copied.record()
        return rows

    def forward(self, ids):
        as_torch = isinstance(ids, torch.Tensor)
        if isinstance(ids, Tensor):
            ids_np = ids.numpy()
        elif as_torch:
            ids_np = ids.detach().cpu().numpy()
        else:
            ids_np = np.asarray(ids)
        flat = ids_np.astype(np.uint64).ravel()
        stats = self.stats
        t0 = time.perf_counter()
        rows = self._to_device(self._client.pull_sparse(self._table_id,
                                                        flat))
        stats["pulls"] += 1
        stats["rows_pulled"] += flat.size
        stats["pull_s"] += time.perf_counter() - t0
        rows.requires_grad_(True)

        if self.training:
            client, tid = self._client, self._table_id
            comm = self._communicator

            def _push(grad):
                t0 = time.perf_counter()
                g = grad.detach().float().cpu().numpy()
                if comm is not None:
                    comm.push_sparse_async(tid, flat, g)
                else:
                    client.push_sparse(tid, flat, g)
                stats["pushes"] += 1
                stats["rows_pushed"] += flat.size
                stats["push_s"] += time.perf_counter() - t0

            rows.register_hook(_push)
        out = rows.reshape(tuple(ids_np.shape) + (self._dim,))
        return out if as_torch else Tensor._wrap(out)

    def extra_repr(self) -> str:
        return (f"table_id={self._table_id}, dim={self._dim}, "
                f"servers={self._client.num_servers}")
