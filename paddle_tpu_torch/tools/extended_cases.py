"""The cases of ``nn.functional``'s extended ops and ``paddle.linalg``, as
the CPU twins and ``chip_smoke.py`` run them.

``CASES[name] = (fn, arrays)``: ``fn(P, *tensors)`` calls a Paddle
namespace ``P`` (the port, or in the tests the JAX package too) on
tensors made from ``arrays``, numpy arrays drawn from fixed seeds, and
returns an output or a list of them. The tests hold each case's outputs
and the grads of its float inputs (``run_case``) against
the JAX package's on the CPU (``tests/test_torch_nn_extended.py``,
``tests/test_torch_linalg.py``); ``chip_smoke.py`` holds them on
``cuda`` against the CPU. ``LINALG`` names the ``paddle.linalg`` cases.
Numpy only: it runs where neither JAX nor the tests are.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CASES", "LINALG", "R", "run_case"]


def R(*shape, seed=0, scale=1.0):
    """Seeded standard-normal f32."""
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype("f4")


def _i(hi, shape, seed=0, lo=0):
    return np.random.default_rng(seed).integers(lo, hi, shape)


def _f(name, **kw):
    def call(P, *ts):
        return getattr(P.nn.functional, name)(*ts, **kw)
    return call


def _well_conditioned(n, batch=(), seed=0):
    return (R(*batch, n, n, seed=seed, scale=0.3)
            + 2 * np.eye(n, dtype="f4")).astype("f4")


def _grid(seed=0):
    """A sampling grid ``[2, 5, 6, 2]`` with points inside, on the border
    (±1 and the pixel centres' edges) and outside."""
    g = np.random.default_rng(seed).uniform(-1.3, 1.3, (2, 5, 6, 2))
    g[0, 0, :, 0] = [-1.0, 1.0, -1.0, 1.0, 1.2, -1.2]
    g[0, 1, :, 1] = [-1.0, 1.0, 0.0, 1.0, -1.0, 1.25]
    return g.astype("f4")


def _csr(B=1, H=2, S=6, seed=0):
    """A random block pattern in CSR per (batch, head): each row keeps
    itself and a random subset of the other keys."""
    rng = np.random.default_rng(seed)
    offs = np.zeros((B, H, S + 1), np.int32)
    cols = []
    for b in range(B):
        for h in range(H):
            row_cols = [sorted({r} | set(rng.choice(S, 2, replace=False)))
                        for r in range(S)]
            offs[b, h, 1:] = np.cumsum([len(c) for c in row_cols])
            cols.append(np.concatenate(row_cols))
    nnz = max(len(c) for c in cols)
    cols = np.stack([np.pad(c, (0, nnz - len(c)), constant_values=c[-1])
                     for c in cols]).reshape(B, H, nnz)
    return offs, cols.astype(np.int32)


def _hs_paths():
    """A custom 4-class tree: node ids (-1 past a path's end) and
    codes."""
    table = np.array([[0, 1, -1], [0, 1, 2], [0, 2, -1], [0, -1, -1]])
    code = np.array([[0, 1, 0], [1, 0, 1], [1, 1, 0], [0, 0, 0]])
    return table, code


CASES = {
    "pairwise_distance_p2": (_f("pairwise_distance"),
                             [R(4, 7), R(4, 7, seed=1)]),
    "pairwise_distance_p1_keepdim": (_f("pairwise_distance", p=1.0,
                                        keepdim=True),
                                     [R(2, 3, 5), R(2, 3, 5, seed=1)]),
    "pairwise_distance_pinf": (_f("pairwise_distance", p=float("inf")),
                               [R(3, 6), R(3, 6, seed=2)]),
    "elu_": (lambda P, x: P.nn.functional.elu_(x * 1.0, 0.5),
             [R(3, 4, scale=2.0)]),
    "diag_embed_offset1": (_f("diag_embed", offset=1),
                           [R(2, 3)]),
    "diag_embed_offset_neg_dims": (_f("diag_embed", offset=-2, dim1=2,
                                      dim2=0), [R(2, 3, 4)]),
    "sequence_mask": (_f("sequence_mask", maxlen=6),
                      [np.array([[1, 4], [6, 0]])]),
    "sequence_mask_auto_f32": (_f("sequence_mask", dtype="float32"),
                               [np.array([3, 1, 5])]),
    "hsigmoid_default_tree": (lambda P, x, y, w, b: P.nn.functional.
                              hsigmoid_loss(x, y, 6, w, b),
                              [R(5, 8), _i(6, (5, 1), 1), R(5, 8, seed=2),
                               R(5, 1, seed=3)]),
    "hsigmoid_custom_paths": (lambda P, x, y, w, t, c: P.nn.functional.
                              hsigmoid_loss(x, y, 4, w, None, t, c),
                              [R(4, 5), np.array([0, 1, 2, 3]),
                               R(3, 5, seed=1), *_hs_paths()]),
    "margin_cross_entropy": (_f("margin_cross_entropy", margin2=0.3,
                                scale=16.0, reduction="mean"),
                             [np.tanh(R(6, 5)), _i(5, (6,), 1)]),
    "margin_cross_entropy_softmax": (_f("margin_cross_entropy",
                                        return_softmax=True),
                                     [np.tanh(R(4, 3, seed=2)),
                                      _i(3, (4, 1), 3)]),
    "multi_margin_p1": (_f("multi_margin_loss"), [R(5, 4), _i(4, (5,), 1)]),
    "multi_margin_p2_weight_sum": (lambda P, x, y, w: P.nn.functional.
                                   multi_margin_loss(x, y, 2, 0.5, w, "sum"),
                                   [R(5, 4), _i(4, (5,), 1),
                                    np.abs(R(4, seed=2)) + 0.5]),
    "rnnt_loss_mean": (_f("rnnt_loss"),
                       [R(2, 4, 4, 5), _i(5, (2, 3), 1, lo=1),
                        np.array([4, 3]), np.array([3, 2])]),
    "rnnt_loss_none_blank2": (_f("rnnt_loss", blank=2, reduction="none"),
                              [R(3, 5, 3, 4, seed=2),
                               np.array([[0, 1], [3, 3], [1, 0]]),
                               np.array([5, 2, 4]), np.array([2, 1, 2])]),
    "affine_grid_aligned": (lambda P, th: P.nn.functional.affine_grid(
        th, [2, 3, 4, 5]), [R(2, 2, 3)]),
    "affine_grid_unaligned": (lambda P, th: P.nn.functional.affine_grid(
        th, [2, 1, 3, 6], align_corners=False), [R(2, 2, 3, seed=1)]),
    "grid_sample_bilinear_zeros": (_f("grid_sample"),
                                   [R(2, 3, 4, 5), _grid()]),
    "grid_sample_bilinear_border_unaligned": (
        _f("grid_sample", padding_mode="border", align_corners=False),
        [R(2, 3, 4, 5), _grid(1)]),
    "grid_sample_bilinear_reflection": (
        _f("grid_sample", padding_mode="reflection"),
        [R(2, 3, 4, 5), _grid(2)]),
    "grid_sample_nearest_zeros": (_f("grid_sample", mode="nearest"),
                                  [R(2, 3, 4, 5), _grid(3)]),
    "temporal_shift": (_f("temporal_shift", seg_num=3),
                       [R(6, 8, 2, 2)]),
    "temporal_shift_nhwc": (_f("temporal_shift", seg_num=2, shift_ratio=0.3,
                               data_format="NHWC"), [R(4, 2, 3, 10)]),
    "gather_tree": (_f("gather_tree"),
                    [_i(9, (5, 2, 3)), _i(3, (5, 2, 3), 1)]),
    "sparse_attention": (lambda P, q, k, v, o, c: P.nn.functional.
                         sparse_attention(q, k, v, o, c),
                         [R(1, 2, 6, 8), R(1, 2, 6, 8, seed=1),
                          R(1, 2, 6, 8, seed=2), *_csr()]),
}

LINALG = {
    "cond_2": (lambda P, x: P.linalg.cond(x), [_well_conditioned(4)]),
    "cond_neg2_batched": (lambda P, x: P.linalg.cond(x, -2),
                          [_well_conditioned(3, (2,), 1)]),
    "cond_fro": (lambda P, x: P.linalg.cond(x, "fro"),
                 [_well_conditioned(4, (), 2)]),
    "cond_nuc": (lambda P, x: P.linalg.cond(x, "nuc"),
                 [_well_conditioned(3, (), 3)]),
    "cond_1": (lambda P, x: P.linalg.cond(x, 1), [_well_conditioned(4)]),
    "cond_neg1": (lambda P, x: P.linalg.cond(x, -1), [_well_conditioned(4)]),
    "cond_inf": (lambda P, x: P.linalg.cond(x, float("inf")),
                 [_well_conditioned(3, (2,), 4)]),
    "cond_neginf": (lambda P, x: P.linalg.cond(x, float("-inf")),
                    [_well_conditioned(3, (), 5)]),
    "tensor_cond": (lambda P, x: x.cond("fro"), [_well_conditioned(3)]),
    "multi_dot_3": (lambda P, a, b, c: P.linalg.multi_dot([a, b, c]),
                    [R(4, 6), R(6, 2, seed=1), R(2, 5, seed=2)]),
    "multi_dot_vectors": (lambda P, a, b, c, d: P.linalg.multi_dot(
        [a, b, c, d]), [R(5), R(5, 3, seed=1), R(3, 7, seed=2),
                        R(7, seed=3)]),
    "lu_unpack": (lambda P, x: P.linalg.lu_unpack(*P.linalg.lu(x)),
                  [R(4, 4)]),
    "lu_unpack_batched": (lambda P, x: P.linalg.lu_unpack(*P.linalg.lu(x)),
                          [R(2, 3, 3, seed=1)]),
    "lu_unpack_wide": (lambda P, x: P.linalg.lu_unpack(*P.linalg.lu(x)),
                       [R(3, 5, seed=2)]),
    "lu_unpack_pivots_only": (lambda P, x: P.linalg.lu_unpack(
        *P.linalg.lu(x), unpack_ludata=False)[0], [R(4, 4, seed=3)]),
    "inv": (lambda P, x: P.linalg.inv(x), [_well_conditioned(3)]),
}
CASES.update(LINALG)


def run_case(P, fn, arrays, seed=7):
    """``(outputs, grads)``: a case's outputs as numpy arrays, and the
    grads of its float inputs (by input index) under seeded cotangents,
    one drawn for every float output in order and applied to those that
    carry a gradient. An input no output's gradient reaches has none."""
    ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in arrays]
    out = fn(P, *ts)
    outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
            if o is not None]
    rng = np.random.default_rng(seed)
    loss = None
    for o in outs:
        if np.asarray(o.numpy()).dtype.kind != "f":
            continue
        cot = rng.standard_normal(o.shape).astype("f4")
        if o.stop_gradient:
            continue
        term = (o * P.to_tensor(cot)).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    return ([np.asarray(o.numpy()) for o in outs],
            {i: np.asarray(t.grad.numpy()) for i, t in enumerate(ts)
             if t.grad is not None})
