"""The torch port's ``minimize`` against the JAX package's.

Counterpart of ``test_api.py`` (its metrics tests have their port in
``test_torch_streaming.py``; a sharded run is ROADMAP A.15 and raises).
The loss is ``test_api.py``'s quadratic, in float64 on both sides; the
port is held to the JAX package at rtol 1e-9 and atol 1e-12 (each side
summing in its own order).  A shuffled run draws its permutations from a
``torch.Generator`` and is held bit for bit against ``run_epochs`` on a
generator seeded the same (the JAX package's ``jax.random`` stream has no
torch twin).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu import minimize as jax_minimize  # noqa: E402
from stochqn_tpu_torch import (FusedTrainer, SQNConfig,  # noqa: E402
                               SQN_free, batchify, minimize)
from stochqn_tpu_torch.free import oLBFGS_free  # noqa: E402

RTOL, ATOL = 1e-9, 1e-12


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T
    ta, ja = torch.from_numpy(a), jnp.asarray(a)

    def tloss(x, batch):
        r = x - batch.mean(0)
        return 0.5 * r @ ta @ r

    def jloss(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * r @ ja @ r
    return tloss, jloss


def test_minimize_flat_sqn_matches_jax(rng):
    n = 10
    tloss, jloss = _quad(rng, n)
    data = rng.standard_normal((200, n)) * 0.1
    kw = dict(optimizer="SQN", step_size=0.3, batch_size=20, nepochs=20,
              tol=1e-8, mem_size=4, bfgs_upd_freq=5)
    res = minimize(tloss, torch.full((n,), 3.0, dtype=torch.float64),
                   torch.from_numpy(data), **kw)
    ref = jax_minimize(jloss, jnp.ones(n) * 3.0, jnp.asarray(data), **kw)
    assert res.losses[-1] <= res.losses[0]
    assert res.losses[-1] < 1e-3
    assert res.nepochs_run == ref.nepochs_run <= 20
    np.testing.assert_allclose(res.losses, ref.losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)
    assert res.info_counts == ref.info_counts
    assert "no_problems_encountered" in res.info_counts


def test_minimize_pytree_adaqn_matches_jax(rng):
    n = 8
    tloss_flat, jloss_flat = _quad(rng, n)

    def tloss(p, batch):
        return tloss_flat(torch.cat([p["a"], p["b"]]), batch)

    def jloss(p, batch):
        return jloss_flat(jnp.concatenate([p["a"], p["b"]]), batch)

    data = rng.standard_normal((120, n)) * 0.1
    kw = dict(optimizer="adaQN", step_size=0.3, batch_size=20, nepochs=15,
              tol=1e-9, mem_size=4, bfgs_upd_freq=3, fisher_size=12)
    x0 = {"a": torch.full((3,), 2.0, dtype=torch.float64),
          "b": torch.full((n - 3,), 2.0, dtype=torch.float64)}
    res = minimize(tloss, x0, torch.from_numpy(data), **kw)
    ref = jax_minimize(jloss, {"a": jnp.ones(3) * 2, "b": jnp.ones(n - 3) * 2},
                       jnp.asarray(data), **kw)
    assert set(res.x.keys()) == {"a", "b"}
    assert res.losses[-1] < res.losses[0] * 0.1
    for k in ("a", "b"):
        np.testing.assert_allclose(res.x[k].numpy(), np.asarray(ref.x[k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("optimizer", ["oLBFGS", "SQN"])
def test_minimize_decay_and_prebatched_match_jax(rng, optimizer):
    """Pre-batched data (``batch_size=None``), a decaying schedule and no
    tol: the same steps as the JAX package."""
    n = 6
    tloss, jloss = _quad(rng, n)
    data = rng.standard_normal((8, 10, n)) * 0.1

    def decay(s0, k):
        return s0 / (k + 1.0)
    kw = dict(optimizer=optimizer, step_size=0.2, nepochs=3,
              decr_step_size=decay, mem_size=3,
              **({"bfgs_upd_freq": 4} if optimizer == "SQN" else {}))
    res = minimize(tloss, torch.ones(n, dtype=torch.float64),
                   torch.from_numpy(data), **kw)
    ref = jax_minimize(jloss, jnp.ones(n), jnp.asarray(data), **kw)
    assert res.losses == [] and res.nepochs_run == 3
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(res.state.x.numpy(), np.asarray(ref.state.x),
                               rtol=RTOL, atol=ATOL)


def test_minimize_shuffle_key_is_a_generator(rng):
    n = 6
    tloss, _ = _quad(rng, n)
    data = torch.from_numpy(rng.standard_normal((120, n)) * 0.1)
    res = minimize(tloss, torch.ones(n, dtype=torch.float64), data,
                   optimizer="SQN", step_size=0.2, batch_size=20, nepochs=4,
                   mem_size=3, bfgs_upd_freq=3,
                   shuffle_key=torch.Generator().manual_seed(5))
    trainer = FusedTrainer("SQN", SQNConfig.create(mem_size=3,
                                                   bfgs_upd_freq=3),
                           torch.func.grad(tloss), obj_fn=tloss)
    state, _ = trainer.run_epochs(
        trainer.init(torch.ones(n, dtype=torch.float64)),
        batchify(data, 20), 4, 0.2,
        shuffle=torch.Generator().manual_seed(5))
    assert torch.equal(res.x, state.x)


def test_minimize_errors_and_device(rng):
    n = 4
    tloss, _ = _quad(rng, n)
    data = torch.zeros(40, n, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="A.15"):
        minimize(tloss, torch.ones(n, dtype=torch.float64), data,
                 batch_size=10, mesh=object())
    with pytest.raises(ValueError, match="unknown optimizer"):
        minimize(tloss, torch.ones(n, dtype=torch.float64), data,
                 batch_size=10, optimizer="Adam")
    if not torch.cuda.is_available():
        # a numpy x0 goes to the card, and there is none: no CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            minimize(tloss, np.ones(n), data.numpy(), batch_size=10)


def test_free_mode_rejects_wrong_inputs(rng):
    """The reference's update_gradient length checks
    (stochqn/_optimizers.py:917-927), and a state of another dtype is not
    adopted."""
    opt = SQN_free(mem_size=3, bfgs_upd_freq=4, device="cpu")
    opt.run_optimizer(rng.standard_normal(8), 0.05)
    with pytest.raises(ValueError, match="gradient has 5"):
        opt.update_gradient(np.zeros(5))
    opt.update_gradient(np.zeros(8))
    with pytest.raises(ValueError, match="hess_vec has 3"):
        opt.update_hess_vec(np.zeros(3))
    f32 = oLBFGS_free(use_float=True, device="cpu")
    f32.run_optimizer(np.zeros(3, np.float32), 0.1)
    with pytest.raises(ValueError, match="float32"):
        oLBFGS_free(device="cpu").adopt_state(f32.state)
