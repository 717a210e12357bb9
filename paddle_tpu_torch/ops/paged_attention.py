"""Ragged paged attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``. Layout, as
there (``serving/kv_cache.py`` owns the pool):

- ``q``            ``[T, num_heads, head_dim]`` -- one row per query token
- ``k/v pool``     ``[num_pages, page_size, num_kv_heads, head_dim]``
- ``block_tables`` ``[T, pages_per_seq]`` int32 -- page ids, 0-padded
  (page 0 is the pool's null page, never given to a sequence)
- ``seq_lens``     ``[T]`` int32 -- keys each row sees (position + 1)
- ``k_scale/v_scale`` ``[num_pages, page_size, num_kv_heads]`` f32 --
  per-slot dequantisation scales of int8 pages, both or neither

The ragged form (``ragged_paged_attention``) is the same function over
flattened rows: a slot's prompt chunk contributes one row per token, each
with the slot's block table and its own position, so the step that has
already written the chunk's KV gets causal attention over it.

Dispatch is on the tensors' device, never on what is installed: CPU
tensors take :func:`ref_paged_attention`; CUDA tensors launch the kernel
in ``csrc/paged_attention.cu`` or raise. ``kernel_launches`` and
``plain_calls`` count the two paths (one launch a call, its merge pass
included). A call made while its stream is being captured into a CUDA
graph launches nothing then: it counts in ``captured_launches``, and the
graph's owner adds the launches each replay makes with
:func:`count_replays` (``replayed_launches``).

The kernel splits each row's pages into partitions (flash-decoding) and
serves the rows of a chunk tile together; :func:`launch_plan` sets both
from shapes alone, so a call reads nothing of the device on the host.
With more than one partition, each writes a partial softmax state (m,
l, acc) to a workspace and a merge pass combines them: :func:`ref_partials`
and :func:`ref_merge` are the plain versions of the two halves. The
workspace is allocated per call unless the caller passes one of at least
:func:`workspace_numel` f32 elements (a captured step owns one, so its
address stays fixed across replays).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["paged_attention", "ragged_paged_attention",
           "ref_paged_attention", "ref_partials", "ref_merge", "launch_plan",
           "LaunchPlan", "workspace_numel", "reset_counters", "count_replays",
           "NEG_INF"]

NEG_INF = -1e30

# plain-integer counts of the two paths (read and zeroed by chip_smoke.py):
# eager launches, calls recorded into a CUDA graph, launches made by
# replaying such graphs, and plain-version calls
kernel_launches = 0
captured_launches = 0
replayed_launches = 0
plain_calls = 0

# f32 bytes of gathered K the plain version holds at once; rows beyond
# it are processed in blocks (the math is per row, so blocking is exact)
_REF_BLOCK_BYTES = 512 << 20

# the launch plan: enough blocks for four waves of the H100's 132 SMs, no
# partition under 128 keys, at most 8 rows or 16 query vectors a tile
_TARGET_BLOCKS = 4 * 132
_MIN_PART_KEYS = 128
_MAX_TILE_ROWS = 8
_MAX_TILE_QUERIES = 16

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_counters() -> None:
    global kernel_launches, captured_launches, replayed_launches, plain_calls
    kernel_launches = 0
    captured_launches = 0
    replayed_launches = 0
    plain_calls = 0


def count_replays(n: int) -> None:
    """Record ``n`` kernel launches made by a CUDA-graph replay (the
    calls its capture recorded)."""
    global replayed_launches
    replayed_launches += int(n)


# ───────────────────────── plain PyTorch version ─────────────────────────


def _ref_rows(q, k_pool, v_pool, bt, lens, scale, k_scale, v_scale):
    B, nh, hd = q.shape
    nkv = k_pool.shape[2]
    groups = nh // nkv
    k = k_pool[bt].reshape(B, -1, nkv, hd)
    v = v_pool[bt].reshape(B, -1, nkv, hd)
    if k_scale is not None:
        ks = k_scale[bt].reshape(B, -1, nkv)
        vs = v_scale[bt].reshape(B, -1, nkv)
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    if groups > 1:  # GQA: repeat kv per query group
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = pos < lens.to(torch.int64)[:, None]
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return out.to(q.dtype)


def ref_paged_attention(q, k_pool, v_pool, block_tables, seq_lens,
                        scale: float = None, k_scale=None, v_scale=None):
    """Gather-based paged attention in plain PyTorch: the CPU path and the
    kernel's yardstick. Gathers each row's pages, masks keys at or past
    ``seq_lens`` to -1e30, softmax in f32, GQA by repeating kv heads,
    int8 pages widened by their scales; output in q's dtype. Rows are
    processed in blocks so the gathered f32 pages stay within a fixed
    size."""
    T, nh, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bt = block_tables.to(torch.int64)
    row_bytes = 4 * bt.shape[1] * k_pool.shape[1] * nh * hd
    block = max(1, _REF_BLOCK_BYTES // max(row_bytes, 1))
    outs = [_ref_rows(q[r:r + block], k_pool, v_pool, bt[r:r + block],
                      seq_lens[r:r + block], scale, k_scale, v_scale)
            for r in range(0, T, block)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ───────────────────────── launch plan and merge ─────────────────────────


class LaunchPlan(NamedTuple):
    """How the kernel cuts one call: ``n_split`` partitions of
    ``part_pages`` pages of each row's block table, and row tiles of
    ``rows_per_tile`` rows (a tile's rows are served by one block when
    their tables agree)."""
    n_split: int
    part_pages: int
    rows_per_tile: int

    def partitions(self, pages_per_seq: int):
        """``[j0, j1)`` page ranges of the partitions, in order."""
        return [(s * self.part_pages,
                 min((s + 1) * self.part_pages, pages_per_seq))
                for s in range(self.n_split)]


@functools.lru_cache(maxsize=256)
def launch_plan(T: int, nh: int, nkv: int, page_size: int,
                pages_per_seq: int) -> LaunchPlan:
    """The kernel's plan from shapes only (never the lengths or tables,
    which live on the device). Enough partitions that the grid of (T, nkv,
    n_split) blocks fills the card four times over, each partition at
    least 128 keys long; ``n_split`` 1 when the rows alone fill it (then
    there is no merge pass). Row tiles: the most rows, a power of two up
    to 8, whose query vectors (rows x GQA group) stay within 16."""
    groups = nh // nkv
    want = -(-_TARGET_BLOCKS // max(1, T * nkv))
    part = max(-(-pages_per_seq // want), -(-_MIN_PART_KEYS // page_size))
    part = min(part, pages_per_seq)
    rows = 1
    while rows * 2 <= _MAX_TILE_ROWS and rows * 2 * groups <= _MAX_TILE_QUERIES:
        rows *= 2
    return LaunchPlan(-(-pages_per_seq // part), part, rows)


def workspace_numel(T: int, nh: int, nkv: int, hd: int, page_size: int,
                    pages_per_seq: int) -> int:
    """f32 elements of the split workspace a call of these shapes needs
    (0 when its plan takes no split): a partial (m, l, acc[hd]) per
    partition, row and head."""
    plan = launch_plan(T, nh, nkv, page_size, pages_per_seq)
    return plan.n_split * T * nh * (hd + 2) if plan.n_split > 1 else 0


def ref_partials(q, k_pool, v_pool, block_tables, seq_lens, plan: LaunchPlan,
                 scale: float = None, k_scale=None, v_scale=None):
    """Plain version of the kernel's first half: per partition ``s`` of
    ``plan``, each row's softmax state over its keys in pages ``[j0,
    j1)`` below its length, in f32: ``m [n_split, T, nh]`` (the largest
    scaled score, -1e30 where the partition holds no key of the row),
    ``l`` (sum of exp(score - m)) and ``acc [n_split, T, nh, hd]`` (the
    unnormalised p.v)."""
    T, nh, hd = q.shape
    page_size, nkv = k_pool.shape[1], k_pool.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    groups = nh // nkv
    pps = block_tables.shape[1]
    bt = block_tables.to(torch.int64)
    lens = seq_lens.to(torch.int64).clamp(max=pps * page_size)
    ms, ls, accs = [], [], []
    for j0, j1 in plan.partitions(pps):
        pages = bt[:, j0:j1]
        k = k_pool[pages].reshape(T, -1, nkv, hd).float()
        v = v_pool[pages].reshape(T, -1, nkv, hd).float()
        if k_scale is not None:
            k = k * k_scale[pages].reshape(T, -1, nkv)[..., None]
            v = v * v_scale[pages].reshape(T, -1, nkv)[..., None]
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
        s = torch.einsum("thd,tkhd->thk", q.float(), k) * scale
        pos = j0 * page_size + torch.arange(k.shape[1], device=q.device)
        valid = (pos[None, :] < lens[:, None])[:, None, :]
        m = s.masked_fill(~valid, NEG_INF).amax(-1)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("thk,tkhd->thd", p, v))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def ref_merge(m, l, acc, dtype=torch.float32):
    """Plain version of the merge pass: ``o = sum_s acc_s e^(m_s - M) /
    max(sum_s l_s e^(m_s - M), 1e-30)``, ``M = max_s m_s``, in
    ``dtype``."""
    mm = m.amax(0)
    f = torch.exp(m - mm)
    total = (l * f).sum(0).clamp_min(1e-30)
    return ((acc * f[..., None]).sum(0) / total[..., None]).to(dtype)


# ───────────────────────── CUDA kernel ─────────────────────────


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, k_scale, v_scale, block_tables, row_lens, out, ws; T,
        # nh, nkv, hd, page_size, pages_per_seq, n_split, part_pages,
        # rows_per_tile; scale; q and kv dtype codes; stream
        fn.argtypes = ([p] * 9 + [i] * 9 + [ctypes.c_float, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(device, *args) -> int:
    """``paged_attention_launch(*args, stream)`` on ``device``, with
    PyTorch's current stream there; returns its cudaError_t."""
    fn = _lib()
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens, scale,
                          k_scale, v_scale, workspace=None):
    global kernel_launches, captured_launches
    T, nh, hd = q.shape
    num_pages, page_size, nkv, hd_kv = k_pool.shape
    quantized = k_scale is not None
    tensors = [q, k_pool, v_pool, block_tables, seq_lens]
    if quantized:
        tensors += [k_scale, v_scale]
    _check(all(t.device == q.device for t in tensors),
           "every tensor must be on q's device")
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} (f32 or bf16)")
    _check(k_pool.dtype in _KV_CODES and v_pool.dtype == k_pool.dtype,
           f"page dtypes {k_pool.dtype}/{v_pool.dtype} (f32, bf16 or int8, "
           "k and v alike)")
    _check(k_pool.dtype != torch.int8 or quantized,
           "int8 pages need k_scale and v_scale")
    _check(tuple(v_pool.shape) == tuple(k_pool.shape),
           "k and v pools differ in shape")
    _check(hd_kv == hd, f"head_dim {hd} of q vs {hd_kv} of the pages")
    _check(nkv > 0 and nh % nkv == 0 and nh // nkv <= 16,
           f"{nh} query heads over {nkv} kv heads (groups <= 16)")
    _check(hd % 8 == 0 and hd <= 256, f"head_dim {hd} (multiple of 8, <= 256)")
    _check(1 <= page_size <= 64, f"page_size {page_size} (1..64)")
    _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
           and block_tables.shape[0] == T and block_tables.shape[1] >= 1,
           "block_tables must be int32 [T, pages_per_seq]")
    _check(seq_lens.dtype == torch.int32 and tuple(seq_lens.shape) == (T,),
           "seq_lens must be int32 [T]")
    if quantized:
        _check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32
               and tuple(k_scale.shape) == (num_pages, page_size, nkv)
               and tuple(v_scale.shape) == (num_pages, page_size, nkv),
               "scales must be f32 [num_pages, page_size, nkv]")
    _check(all(t.is_contiguous() for t in tensors),
           "every tensor must be contiguous")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "the pools' data pointers must be 16-byte aligned (the kernel "
           "copies pages 16 bytes at a time)")
    out = torch.empty_like(q)
    if T == 0:
        return out
    pps = block_tables.shape[1]
    plan = launch_plan(T, nh, nkv, page_size, pps)
    need = workspace_numel(T, nh, nkv, hd, page_size, pps)
    ws = None
    if need and workspace is not None:
        _check(workspace.dtype == torch.float32
               and workspace.device == q.device
               and workspace.is_contiguous() and workspace.numel() >= need,
               f"workspace must be contiguous f32 on q's device with at least "
               f"{need} elements")
        ws = workspace
    elif need:
        ws = torch.empty(need, dtype=torch.float32, device=q.device)
    rc = _launch(q.device, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None,
                 T, nh, nkv, hd, page_size, pps, plan.n_split,
                 plan.part_pages, plan.rows_per_tile, float(scale),
                 _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype])
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError_t {rc}")
    if q.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        captured_launches += 1
    else:
        kernel_launches += 1
    return out


# ───────────────────────── public op ─────────────────────────


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens,
                    scale: float = None, k_scale=None, v_scale=None,
                    workspace=None):
    """Paged attention of each row of ``q`` over its block table (module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel, raising on a shape, dtype or launch it does not take.
    ``workspace``: the kernel's split workspace (module docstring); the
    plain version needs none."""
    global plain_calls
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        plain_calls += 1
        return ref_paged_attention(q, k_pool, v_pool, block_tables, seq_lens,
                                   scale, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention: no path for device {q.device}")
    return _paged_attention_cuda(q, k_pool, v_pool, block_tables, seq_lens,
                                 scale, k_scale, v_scale, workspace)


def ragged_paged_attention(q, k_pool, v_pool, row_block_tables, row_lens,
                           scale: float = None, k_scale=None, v_scale=None,
                           workspace=None):
    """Mixed query-length paged attention over a flattened token grid:
    ``q`` ``[T, nh, hd]`` holds decode tokens and prompt-chunk tokens
    alike, ``row_block_tables`` repeats a slot's table for each of its
    rows, ``row_lens`` is each row's position + 1. The caller has already
    written this step's KV into the pool."""
    return paged_attention(q, k_pool, v_pool, row_block_tables, row_lens,
                           scale=scale, k_scale=k_scale, v_scale=v_scale,
                           workspace=workspace)
