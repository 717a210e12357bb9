"""Twin runner of the extended-ops and ``paddle.linalg`` tests: a case
of ``paddle_tpu_torch/tools/extended_cases.py`` runs through both
packages (``run_case``) on the same numpy inputs; outputs, dtypes and
the inputs' grads must agree at ``tol`` (f32). A grad that only the JAX
package gives must be all zeros: its tape gives every float input of an
op a grad, torch autograd none to an input no output's gradient reaches
(ROADMAP Queue 3, differences by design)."""
import numpy as np

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu_torch.tools.extended_cases import CASES, run_case

TOL = 1e-5


def check_case(name, tol=TOL):
    fn, arrays = CASES[name]
    (jo, jg), (to, tg) = run_case(pt, fn, arrays), run_case(paddle, fn,
                                                             arrays)
    assert len(jo) == len(to), (len(jo), len(to))
    for i, (a, b) in enumerate(zip(jo, to)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype,
                                                           b.dtype)
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                   err_msg=f"output {i}")
    assert set(tg) <= set(jg), (set(tg), set(jg))
    for i, g in jg.items():
        if i in tg:
            np.testing.assert_allclose(tg[i], g, rtol=tol, atol=tol,
                                       err_msg=f"grad of input {i}")
        else:
            assert not np.any(g), f"grad of input {i}: JAX only, nonzero"
