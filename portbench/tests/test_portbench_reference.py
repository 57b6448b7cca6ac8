"""The plain reference against the program at tiny sizes on the CPU (a
test may import both)."""
import pytest
import torch

from portbench.reference import losses as ref
from portbench.reference import sqn as ref_sqn
from stochqn_tpu_torch.models import losses, sparse


@pytest.fixture
def dense():
    g = torch.Generator().manual_seed(3)
    F, K, B = 7, 4, 9
    X = torch.randn(B, F, generator=g, dtype=torch.float64)
    Y = torch.nn.functional.one_hot(torch.randint(0, K, (B,), generator=g),
                                    K).double()
    w = torch.rand(B, generator=g, dtype=torch.float64)
    x = torch.randn(K * (F + 1), generator=g, dtype=torch.float64)
    v = torch.randn(K * (F + 1), generator=g, dtype=torch.float64)
    return x, v, X, Y, w


@pytest.fixture
def padded():
    g = torch.Generator().manual_seed(4)
    n, B, k = 30, 8, 5
    idx = torch.randint(0, n, (B, k), generator=g)
    val = torch.rand(B, k, generator=g, dtype=torch.float64)
    val[:, -1] = 0
    y = torch.where(torch.rand(B, generator=g) < 0.3, 1.0, -1.0).double()
    x = torch.randn(n, generator=g, dtype=torch.float64)
    v = torch.randn(n, generator=g, dtype=torch.float64)
    return x, v, idx, val, y, n


@pytest.mark.parametrize("w", [False, True])
def test_dense_functions(dense, w):
    x, v, X, Y, sw = dense
    sw = sw if w else None
    torch.testing.assert_close(ref.multinomial_loss(x, X, Y, sw, 0.3),
                               losses.multinomial_logistic_loss(x, X, Y, sw,
                                                                0.3))
    torch.testing.assert_close(ref.multinomial_grad(x, X, Y, sw, 0.3),
                               losses.multinomial_logistic_grad(x, X, Y, sw,
                                                                0.3))
    torch.testing.assert_close(
        ref.multinomial_hessvec(x, v, X, Y, sw, 0.3),
        losses.multinomial_logistic_hessvec(x, v, X, Y, sw, 0.3))


def test_sparse_functions(padded):
    x, v, idx, val, y, n = padded
    torch.testing.assert_close(
        ref.sparse_binary_loss(x, idx, val, y, 0.5),
        sparse.sparse_binary_logistic_loss(x, idx, val, y, n, None, 0.5))
    torch.testing.assert_close(
        ref.sparse_binary_grad(x, idx, val, y, 0.5),
        sparse.sparse_binary_logistic_grad(x, idx, val, y, n, None, 0.5))
    torch.testing.assert_close(
        ref.sparse_binary_hessvec(x, v, idx, val, y, 0.5),
        sparse.sparse_binary_logistic_hessvec(x, v, idx, val, y, n, None,
                                              0.5))


def test_two_loop_equals_the_inverse_hessian_of_one_pair():
    # with one pair the two-loop is the BFGS update of gamma I
    g = torch.Generator().manual_seed(5)
    s, y, q = (torch.randn(6, generator=g, dtype=torch.float64)
               for _ in range(3))
    y = y + 3 * s                                  # s.y > 0
    rho, gamma = 1 / s.dot(y), s.dot(y) / y.dot(y)
    eye = torch.eye(6, dtype=torch.float64)
    V = eye - rho * torch.outer(y, s)
    H = gamma * V.T @ V + rho * torch.outer(s, s)
    torch.testing.assert_close(ref_sqn.two_loop(q, [s], [y]), H @ q)


@pytest.mark.parametrize("cell", ["tiny_dense.graph", "tiny_sparse.graph",
                                  "tiny_dense.free", "tiny_dense.fit"])
def test_program_agrees_with_the_reference(tiny, cell):
    from portbench import harness
    ctx = harness.Context(tiny, cell, 2**31 + 17, torch.device("cpu"))
    result, _ = harness.run_cell(ctx, 0.2, False)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
