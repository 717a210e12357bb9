"""``paddle.geometric`` and ``incubate``'s top-level ops (the masked
softmaxes, ``identity_loss``, the ``graph_*`` and ``segment_*`` aliases)
against the JAX package.

Values and input gradients under a seeded cotangent at f32 rtol 1e-5 /
atol 1e-6 (gradients 1e-4); min and max, and their gradients at ties,
exactly (``segment_max``'s gradient at a tie is split evenly among the
tied rows in both packages). Integer outputs (reindexing, full-
neighbourhood sampling) exactly. A sampled draw comes from each
package's own generator, so it is held by its invariants: counts,
membership in the node's neighbourhood, no repeats, and the same draw
again under the same ``paddle.seed``.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from torch_facade_common import on_cpu  # noqa: F401
from torch_suite import one_torch_thread  # noqa: F401

TOL, GRAD_TOL = (1e-5, 1e-6), 1e-4


def R(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype("f4")


# rows 0, 2 and 3 tie in segment 0 (column 0); segment 2 is empty
TIES = np.array([[2.0, 1.0], [1.0, 3.0], [2.0, -1.0], [2.0, 0.5],
                 [-4.0, 2.5], [0.5, 0.5]], "f4")
SEG = np.array([0, 0, 0, 0, 1, 3])
SRC = np.array([0, 1, 2, 3, 4, 5, 0, 2, 5, 1])
DST = np.array([1, 1, 1, 0, 0, 2, 4, 4, 4, 5])
X = np.array([[1.0, 2.0], [1.0, -1.0], [3.0, 2.0], [1.0, 0.0],
              [0.0, 0.0], [-2.0, 1.0]], "f4")   # ties among messages


def _run(P, fn, floats, ints):
    ts = [P.to_tensor(a, stop_gradient=False) for a in floats]
    out = fn(P, *ts, *[P.to_tensor(a) for a in ints])
    rng = np.random.default_rng(3)
    (out * P.to_tensor(rng.standard_normal(out.shape).astype(
        "f4"))).sum().backward()
    return [np.asarray(out.numpy())] + [np.asarray(t.grad.numpy())
                                        for t in ts]


def _seg(kind, alias=False):
    def fn(P, d, s):
        mod = P.incubate if alias else P.geometric
        return getattr(mod, f"segment_{kind}")(d, s)
    return fn


def _send(reduce_op, out_size=None, alias=False):
    def fn(P, x, s, d):
        if alias:
            return P.incubate.graph_send_recv(x, s, d, pool_type=reduce_op,
                                              out_size=out_size)
        return P.geometric.send_u_recv(x, s, d, reduce_op=reduce_op,
                                       out_size=out_size)
    return fn


def _send_ue(message_op, reduce_op, out_size=None):
    def fn(P, x, y, s, d):
        return P.geometric.send_ue_recv(x, y, s, d, message_op=message_op,
                                        reduce_op=reduce_op,
                                        out_size=out_size)
    return fn


def _send_uv(message_op):
    def fn(P, x, y, s, d):
        return P.geometric.send_uv(x, y, s, d, message_op=message_op)
    return fn


EDGE_Y = np.abs(R(len(SRC), 2, seed=5)) + 0.5
CASES = {
    **{f"segment_{k}": (_seg(k), [TIES], [SEG])
       for k in ("sum", "mean", "min", "max")},
    **{f"incubate_segment_{k}": (_seg(k, True), [R(6, 2)], [SEG])
       for k in ("sum", "mean", "min", "max")},
    **{f"send_u_recv_{k}": (_send(k), [X], [SRC, DST])
       for k in ("sum", "mean", "min", "max")},
    "send_u_recv_max_out_size_4": (_send("max", 4), [X], [SRC, DST]),
    "send_u_recv_sum_out_size_8": (_send("sum", 8), [X], [SRC, DST]),
    "graph_send_recv_mean": (_send("mean", alias=True), [R(6, 2)],
                             [SRC, DST]),
    **{f"send_ue_recv_{m}_{r}": (_send_ue(m, r), [X, EDGE_Y], [SRC, DST])
       for m, r in (("add", "sum"), ("sub", "max"), ("mul", "mean"),
                    ("div", "min"))},
    "send_ue_recv_add_out_size_3": (_send_ue("add", "sum", 3), [X, EDGE_Y],
                                    [SRC, DST]),
    **{f"send_uv_{m}": (_send_uv(m), [X, np.abs(X) + 1.0], [SRC, DST])
       for m in ("add", "sub", "mul", "div")},
    "softmax_mask_fuse": (lambda P, x, m: P.incubate.softmax_mask_fuse(x, m),
                          [R(2, 3, 4, 4), R(2, 1, 4, 4, seed=1)], []),
    "softmax_mask_fuse_upper_triangle": (
        lambda P, x: P.incubate.softmax_mask_fuse_upper_triangle(x),
        [R(2, 3, 5, 5)], []),
    **{f"identity_loss_{r}": (
        lambda P, x, r=r: P.incubate.identity_loss(x, reduction=r) * 1.0,
        [R(3, 4)], []) for r in ("sum", "mean", "none", 0, 1)},
}
EXACT = {"segment_min", "segment_max", "send_u_recv_min",
         "send_u_recv_max", "send_u_recv_max_out_size_4"}


@pytest.fixture(scope="module")
def jax_side():
    return {name: _run(pt, fn, floats, ints)
            for name, (fn, floats, ints) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax(jax_side, name):
    fn, floats, ints = CASES[name]
    got = _run(paddle, fn, floats, ints)
    want = jax_side[name]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {i}")
        else:
            tol = TOL if i == 0 else (GRAD_TOL, GRAD_TOL)
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=f"{name} {i}")


def test_segment_max_splits_a_tie_evenly():
    """Segment 0 of column 0 is 2.0 at rows 0, 2 and 3: each gets a third
    of the cotangent in both packages; the empty segment 2 is 0."""
    for P in (pt, paddle):
        d = P.to_tensor(TIES, stop_gradient=False)
        out = P.geometric.segment_max(d, P.to_tensor(SEG))
        out.sum().backward()
        g = np.asarray(d.grad.numpy())
        np.testing.assert_allclose(g[[0, 2, 3], 0], [1 / 3] * 3, rtol=1e-6)
        assert g[1, 0] == 0.0
        np.testing.assert_array_equal(np.asarray(out.numpy())[2], [0, 0])


# a CSC graph of 6 nodes: node i's in-neighbours row[colptr[i]:colptr[i+1]]
ROW = np.array([1, 2, 3, 4, 0, 2, 5, 0, 1, 3, 4, 5, 2, 0, 1, 3])
COLPTR = np.array([0, 4, 7, 12, 13, 13, 16])
EIDS = np.arange(100, 100 + len(ROW))
NODES = np.array([0, 2, 4, 5])


def _ints(out):
    if isinstance(out, (list, tuple)):
        return [_ints(o) for o in out]
    return np.asarray(out.numpy()).tolist()


def _host_cases(P):
    G = P.geometric
    t = P.to_tensor
    out = {
        "reindex": G.reindex_graph(t(np.array([5, 0, 9])),
                                   t(np.array([0, 7, 9, 7, 3, 5])),
                                   t(np.array([2, 3, 1]))),
        "reindex_alias": P.incubate.graph_reindex(
            t(np.array([1, 2])), t(np.array([2, 4, 4, 1])),
            t(np.array([1, 3]))),
        "reindex_heter": G.reindex_heter_graph(
            t(np.array([5, 0])), [t(np.array([0, 7, 9])),
                                  t(np.array([7, 3, 5, 5]))],
            [t(np.array([2, 1])), t(np.array([1, 3]))]),
        "sample_all": G.sample_neighbors(t(ROW), t(COLPTR), t(NODES),
                                         eids=t(EIDS), return_eids=True),
        "sample_all_alias": P.incubate.graph_sample_neighbors(
            t(ROW), t(COLPTR), t(NODES)),
        "weighted_all": G.weighted_sample_neighbors(
            t(ROW), t(COLPTR), t(np.linspace(0.5, 2, len(ROW))), t(NODES)),
        "khop_all": P.incubate.graph_khop_sampler(
            t(ROW), t(COLPTR), t(np.array([0, 4])), [-1, -1]),
    }
    return {k: _ints(v) for k, v in out.items()}


def test_host_side_graph_ops_match_jax():
    """Reindexing and full-neighbourhood sampling, integer for integer
    (count dtypes as the JAX package's: int32 for ``sample_neighbors``,
    int64 for the weighted one)."""
    assert _host_cases(paddle) == _host_cases(pt)
    cnt = paddle.geometric.sample_neighbors(
        paddle.to_tensor(ROW), paddle.to_tensor(COLPTR),
        paddle.to_tensor(NODES))[1]
    assert cnt.dtype == paddle.int32
    with pytest.raises(ValueError):
        paddle.geometric.sample_neighbors(
            paddle.to_tensor(ROW), paddle.to_tensor(COLPTR),
            paddle.to_tensor(NODES), return_eids=True)


def _check_sample(nb, cnt, eids, size):
    nb, cnt = np.asarray(nb.numpy()), np.asarray(cnt.numpy())
    degrees = np.diff(COLPTR)[NODES]
    np.testing.assert_array_equal(cnt, np.minimum(degrees, size))
    start = 0
    for node, c in zip(NODES, cnt):
        part = nb[start:start + c]
        hood = ROW[COLPTR[node]:COLPTR[node + 1]]
        assert set(part) <= set(hood)
        if eids is not None:
            e = np.asarray(eids.numpy())[start:start + c]
            assert len(set(e)) == c          # no edge drawn twice
            np.testing.assert_array_equal(ROW[e - 100], part)
        start += c
    return nb


@pytest.mark.parametrize("weighted", [False, True])
def test_sampled_neighbours_keep_the_invariants(weighted):
    def draw(seed):
        paddle.seed(seed)
        t = paddle.to_tensor
        if weighted:
            return paddle.geometric.weighted_sample_neighbors(
                t(ROW), t(COLPTR), t(np.linspace(0.5, 2, len(ROW))),
                t(NODES), sample_size=2, eids=t(EIDS), return_eids=True)
        return paddle.geometric.sample_neighbors(
            t(ROW), t(COLPTR), t(NODES), sample_size=2, eids=t(EIDS),
            return_eids=True)

    a = _check_sample(*draw(4), 2)
    b = _check_sample(*draw(4), 2)
    np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, _check_sample(*draw(s), 2))
               for s in range(5, 12))


def test_khop_sampler_keeps_its_contract():
    paddle.seed(1)
    t = paddle.to_tensor
    src, dst, index, reindex = paddle.incubate.graph_khop_sampler(
        t(ROW), t(COLPTR), t(np.array([0, 4])), [2, 2])
    src, dst, index = (np.asarray(v.numpy()) for v in (src, dst, index))
    np.testing.assert_array_equal(index[:2], [0, 4])
    np.testing.assert_array_equal(np.asarray(reindex.numpy()), [0, 1])
    assert len(set(index)) == len(index)
    for s, d in zip(index[src], index[dst]):   # every edge is the graph's
        assert s in ROW[COLPTR[d]:COLPTR[d + 1]]
    with pytest.raises(NotImplementedError):
        paddle.incubate.graph_khop_sampler(t(ROW), t(COLPTR), t(NODES),
                                           [2], return_eids=True)
