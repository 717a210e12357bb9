"""n:m sparsity masks and their checks, on the host in numpy: the port's
copy of ``paddle_tpu/incubate/asp/utils.py`` (reference:
``python/paddle/incubate/asp/utils.py``, get_mask_1d :179,
get_mask_2d_greedy, get_mask_2d_best, check_mask_1d :135, check_mask_2d
:262, calculate_density :81). Masks are computed once on the host;
training multiplies them in on the parameters' device (:mod:`.asp`).
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = [
    "calculate_density", "check_mask_1d", "get_mask_1d", "check_mask_2d",
    "get_mask_2d_greedy", "get_mask_2d_best", "create_mask", "check_sparsity",
]


def calculate_density(x) -> float:
    """Fraction of nonzero entries."""
    x = np.asarray(x)
    return float(np.count_nonzero(x)) / x.size


def _reshape_1d(mat: np.ndarray, m: int):
    """Pad the last dim to a multiple of m and view as rows of m."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    pad = (-mat.shape[1]) % m
    if pad:
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], pad), mat.dtype)], axis=1)
    return mat.reshape(-1, m), pad


def check_mask_1d(mat, n: int, m: int) -> bool:
    """True when every group of m consecutive elements of a row (the
    last one zero-padded) has at most n nonzeros."""
    rows, _ = _reshape_1d(np.asarray(mat), m)
    return bool(np.all((rows != 0).sum(axis=1) <= n))


def get_mask_1d(mat, n: int, m: int) -> np.ndarray:
    """Keep the n largest-|w| entries of every m-block of each row."""
    mat = np.asarray(mat)
    rows, pad = _reshape_1d(mat, m)
    order = np.argsort(-np.abs(rows), axis=1, kind="stable")[:, :n]
    mask = np.zeros_like(rows, dtype=mat.dtype)
    np.put_along_axis(mask, order, 1, axis=1)
    mask = mask.reshape(mat.shape[0], -1)
    if pad:
        mask = mask[:, :mat.shape[1]]
    return mask


def _reshape_2d(mat: np.ndarray, m: int):
    """Pad both dims to multiples of m and emit m×m tiles."""
    mat = np.asarray(mat)
    pr = (-mat.shape[0]) % m
    pc = (-mat.shape[1]) % m
    if pr or pc:
        mat = np.pad(mat, ((0, pr), (0, pc)))
    r, c = mat.shape
    tiles = (mat.reshape(r // m, m, c // m, m).transpose(0, 2, 1, 3)
             .reshape(-1, m, m))
    return tiles, (pr, pc), (r, c)


def _tiles_to_mat(tiles: np.ndarray, padded_shape, orig_shape, m: int):
    r, c = padded_shape
    mat = (tiles.reshape(r // m, c // m, m, m).transpose(0, 2, 1, 3)
           .reshape(r, c))
    return mat[:orig_shape[0], :orig_shape[1]]


def check_mask_2d(mat, n: int, m: int) -> bool:
    """True when every m×m tile has at most n nonzeros per row AND per
    column (reference: check_mask_2d)."""
    tiles, _, _ = _reshape_2d(np.asarray(mat), m)
    nz = tiles != 0
    return bool(np.all(nz.sum(axis=2) <= n) and np.all(nz.sum(axis=1) <= n))


def get_mask_2d_greedy(mat, n: int, m: int) -> np.ndarray:
    """Greedy per-tile mask: walk entries in decreasing |w|, keep while the
    entry's row and column budgets (n each) allow."""
    mat = np.asarray(mat)
    tiles, _, padded = _reshape_2d(mat, m)
    masks = np.zeros_like(tiles)
    for t in range(tiles.shape[0]):
        tile = np.abs(tiles[t])
        order = np.dstack(np.unravel_index(
            np.argsort(-tile, axis=None, kind="stable"), (m, m)))[0]
        rows = np.zeros(m, np.int64)
        cols = np.zeros(m, np.int64)
        for i, j in order:
            if rows[i] < n and cols[j] < n:
                masks[t, i, j] = 1
                rows[i] += 1
                cols[j] += 1
    return _tiles_to_mat(masks, padded, mat.shape, m).astype(mat.dtype)


_PATTERNS_CACHE: dict = {}


def _valid_2d_patterns(n: int, m: int) -> np.ndarray:
    """All m×m 0/1 matrices with exactly n ones per row and per column
    (built as permutations of row patterns; reference caches these too)."""
    key = (n, m)
    if key in _PATTERNS_CACHE:
        return _PATTERNS_CACHE[key]
    row_patterns = [p for p in itertools.product([0, 1], repeat=m)
                    if sum(p) == n]
    out = []
    for combo in itertools.product(range(len(row_patterns)), repeat=m):
        mat = np.array([row_patterns[i] for i in combo], np.float64)
        if np.all(mat.sum(axis=0) == n):
            out.append(mat)
    pats = np.stack(out)
    _PATTERNS_CACHE[key] = pats
    return pats


def get_mask_2d_best(mat, n: int, m: int) -> np.ndarray:
    """Optimal per-tile mask: the valid n:m-per-row-and-column pattern with
    the largest retained |w| mass (exhaustive over valid patterns)."""
    mat = np.asarray(mat)
    pats = _valid_2d_patterns(n, m)  # [P, m, m]
    tiles, _, padded = _reshape_2d(mat, m)
    scores = np.einsum("pij,tij->tp", pats, np.abs(tiles).astype(np.float64))
    best = np.argmax(scores, axis=1)
    masks = pats[best]
    return _tiles_to_mat(masks, padded, mat.shape, m).astype(mat.dtype)


_MASK_FNS = {
    "mask_1d": get_mask_1d,
    "mask_2d_greedy": get_mask_2d_greedy,
    "mask_2d_best": get_mask_2d_best,
}
_CHECK_FNS = {
    "mask_1d": check_mask_1d,
    "mask_2d_greedy": check_mask_2d,
    "mask_2d_best": check_mask_2d,
}


def create_mask(tensor, func_name: str = "mask_1d", n: int = 2,
                m: int = 4) -> np.ndarray:
    """Dispatch over the mask algorithms, handling conv (4-D) weights by
    flattening to 2-D the way the reference does (OIHW → [O, I*H*W])."""
    t = np.asarray(tensor)
    shape = t.shape
    if t.ndim == 1:
        mat = t.reshape(1, -1)
    elif t.ndim == 2:
        mat = t
    elif t.ndim == 4:
        mat = t.reshape(shape[0], -1)
    else:
        raise ValueError(f"unsupported weight rank {t.ndim} for ASP")
    fn = _MASK_FNS.get(func_name)
    if fn is None:
        raise ValueError(f"unknown mask algorithm {func_name!r}; choose "
                         f"from {sorted(_MASK_FNS)}")
    return fn(mat, n, m).reshape(shape)


def check_sparsity(tensor, func_name: str = "mask_1d", n: int = 2,
                   m: int = 4) -> bool:
    t = np.asarray(tensor)
    mat = t.reshape(1, -1) if t.ndim == 1 else (
        t.reshape(t.shape[0], -1) if t.ndim != 2 else t)
    return _CHECK_FNS[func_name](mat, n, m)
