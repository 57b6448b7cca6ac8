"""The torch port's logistic losses against the JAX package.

Same float32 inputs on both sides (numpy).  Tolerance: float32 matmuls
and reductions in different orders over 40 rows and 7 features, on
values of order 1-100 (rtol 1e-5, atol 1e-4).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.models import losses as jl  # noqa: E402
from stochqn_tpu_torch.models import losses as tl  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
ROWS, NF, NC, REG = 40, 7, 3, 0.1


def _problem(kind, intercept, weighted):
    rng = np.random.default_rng(17)
    X = rng.standard_normal((ROWS, NF)).astype(np.float32)
    if kind == "binary":
        y = rng.integers(0, 2, ROWS).astype(np.float32)
        n = NF + intercept
    else:
        y = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, ROWS)]
        n = NC * (NF + intercept)
    w = (0.5 * rng.standard_normal(n)).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    sw = (rng.uniform(0.2, 2.0, ROWS).astype(np.float32) if weighted
          else None)
    return X, y, w, v, sw


CASES = [(kind, intercept, weighted)
         for kind in ("binary", "multinomial")
         for intercept in (False, True)
         for weighted in (False, True)]


def _fns(mod, kind):
    pre = "binary" if kind == "binary" else "multinomial"
    return (getattr(mod, f"{pre}_logistic_loss"),
            getattr(mod, f"{pre}_logistic_grad"),
            getattr(mod, f"{pre}_logistic_hessvec"))


@pytest.mark.parametrize("what", ["loss", "grad", "hessvec"])
@pytest.mark.parametrize("kind,intercept,weighted", CASES)
def test_matches_jax(kind, intercept, weighted, what):
    X, y, w, v, sw = _problem(kind, intercept, weighted)
    jfns, tfns = _fns(jl, kind), _fns(tl, kind)
    i = ("loss", "grad", "hessvec").index(what)
    j_sw = None if sw is None else jnp.asarray(sw)
    t_sw = None if sw is None else torch.from_numpy(sw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jargs = (jnp.asarray(X), jnp.asarray(y), j_sw, REG)
    targs = (torch.from_numpy(X), torch.from_numpy(y), t_sw, REG)
    if what == "hessvec":
        want = jfns[i](jw, jnp.asarray(v), *jargs)
        got = tfns[i](tw, torch.from_numpy(v), *targs)
    else:
        want = jfns[i](jw, *jargs)
        got = tfns[i](tw, *targs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind,intercept,weighted", CASES)
def test_hvp_from_grad_matches_closed_form(kind, intercept, weighted):
    X, y, w, v, sw = _problem(kind, intercept, weighted)
    _, grad, hessvec = _fns(tl, kind)
    t_sw = None if sw is None else torch.from_numpy(sw)
    args = (torch.from_numpy(X), torch.from_numpy(y), t_sw, REG)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    got = tl.hvp_from_grad(grad)(tw, tv, *args)
    want = hessvec(tw, tv, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
