"""Streaming ingestion, schedules and metrics of the torch port against the
JAX package's ``stochqn_tpu.utils``.

``stream_rounds`` feeds host minibatches round by round through
``prefetch_to_device`` into ``FusedTrainer.round``; fed the same batches
it must give what ``epochs`` gives, bit for bit inside the port (the same
rounds and ops), and what the JAX package's ``stream_rounds`` gives:
float64 on both sides, rtol 1e-9 and atol 1e-12 (each side sums in its
own order).  The parser, schedules and metrics are exact.
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu.core import config as jcfg  # noqa: E402
from stochqn_tpu.fused import FusedTrainer as JaxTrainer  # noqa: E402
from stochqn_tpu.utils import data as jdata  # noqa: E402
from stochqn_tpu.utils import metrics as jmetrics  # noqa: E402
from stochqn_tpu.utils import schedules as jschedules  # noqa: E402
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer,  # noqa: E402
                               OLBFGSConfig, SQNConfig)
from stochqn_tpu_torch.utils import metrics, schedules  # noqa: E402
from stochqn_tpu_torch.utils.data import (  # noqa: E402
    parse_extreme_classification, prefetch_to_device, rounds_of,
    stream_rounds)

RTOL, ATOL = 1e-9, 1e-12


def _quad(rng, n):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return q @ np.diag(rng.uniform(0.5, 4.0, n)) @ q.T


def _funs(a):
    ja, ta = jnp.asarray(a), torch.from_numpy(a)

    def jgrad(x, batch):
        return ja @ (x - jnp.mean(batch, axis=0))

    def jobj(x, batch):
        r = x - jnp.mean(batch, axis=0)
        return 0.5 * r @ ja @ r

    def tgrad(x, batch):
        return ta @ (x - torch.mean(batch, dim=0))

    def tobj(x, batch):
        r = x - torch.mean(batch, dim=0)
        return 0.5 * r @ ta @ r
    return (jgrad, jobj), (tgrad, tobj)


def test_prefetch_preserves_order():
    batches = [{"a": np.full((2,), i)} for i in range(7)]
    out = list(prefetch_to_device(batches, size=3, device="cpu"))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["a"], torch.Tensor)
        np.testing.assert_array_equal(b["a"].numpy(), [i, i])


def test_prefetch_copies_the_callers_arrays():
    """A batch staged ahead is a copy: refilling the caller's buffer after
    it was yielded changes nothing already staged."""
    buf = np.zeros(3)

    def gen():
        for i in range(4):
            buf[:] = i
            yield buf
    out = [b.clone() for b in prefetch_to_device(gen(), size=2,
                                                 device="cpu")]
    assert [float(b[0]) for b in out] == [0.0, 1.0, 2.0, 3.0]


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device([np.zeros(2)]))


def test_rounds_of_drops_tail():
    batches = [np.full((2,), i) for i in range(10)]
    rounds = list(rounds_of(batches, 4))
    assert len(rounds) == 2
    assert rounds[0].shape == (4, 2)
    np.testing.assert_array_equal(rounds[1][:, 0], [4, 5, 6, 7])
    trounds = list(rounds_of((torch.full((2,), i) for i in range(9)), 3))
    assert len(trounds) == 3 and isinstance(trounds[2], torch.Tensor)
    nested = list(rounds_of([(np.full(2, i), {"y": np.full(1, -i)})
                             for i in range(4)], 2))
    np.testing.assert_array_equal(nested[1][1]["y"][:, 0], [-2, -3])


@pytest.mark.parametrize("numpy_batches", [True, False])
def test_stream_matches_epoch_sqn(rng, numpy_batches):
    """The same batches streamed and as one epoch: the same bits in the
    port; and the JAX package's ``stream_rounds``."""
    n, B, bs, L = 8, 12, 2, 4
    a = _quad(rng, n)
    centers = rng.standard_normal((B, bs, n))
    (jgrad, _), (tgrad, _) = _funs(a)
    trainer = FusedTrainer("SQN", SQNConfig.create(mem_size=3,
                                                   bfgs_upd_freq=L), tgrad)
    st_e, infos_e = trainer.epoch(
        trainer.init(torch.zeros(n, dtype=torch.float64)),
        torch.from_numpy(centers), 0.05)
    feed = (centers[i] if numpy_batches else torch.from_numpy(centers[i])
            for i in range(B))
    st_s, infos_s = stream_rounds(
        trainer, trainer.init(torch.zeros(n, dtype=torch.float64)), feed,
        0.05)
    assert torch.equal(st_s.x, st_e.x) and torch.equal(infos_s, infos_e)
    assert int(st_s.niter) == B

    jtr = JaxTrainer("SQN", jcfg.SQNConfig.create(mem_size=3,
                                                  bfgs_upd_freq=L), jgrad)
    jst, jinfos = jdata.stream_rounds(
        jtr, jtr.init(jnp.zeros(n)),
        (jnp.asarray(centers[i]) for i in range(B)), 0.05)
    np.testing.assert_allclose(st_s.x.numpy(), np.asarray(jst.x), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(infos_s.numpy(), np.asarray(jinfos))


def test_stream_olbfgs_and_adaqn_match_jax(rng):
    """oLBFGS (rounds of one batch) at a constant step, and adaQN at a step
    that a callable gives per round."""
    n, B, bs = 6, 8, 2
    a = _quad(rng, n)
    centers = rng.standard_normal((B, bs, n))
    (jgrad, jobj), (tgrad, tobj) = _funs(a)

    def eta(r):
        return 0.05 / (r + 1)
    runs = [("oLBFGS", jcfg.OLBFGSConfig.create(mem_size=3),
             OLBFGSConfig.create(mem_size=3), {}, {}, 0.05),
            ("adaQN", jcfg.AdaQNConfig.create(mem_size=3, fisher_size=6,
                                              bfgs_upd_freq=4),
             AdaQNConfig.create(mem_size=3, fisher_size=6, bfgs_upd_freq=4),
             {"obj_fn": jobj}, {"obj_fn": tobj}, eta)]
    for kind, jc, tc, jkw, tkw, step in runs:
        jtr = JaxTrainer(kind, jc, jgrad, **jkw)
        ttr = FusedTrainer(kind, tc, tgrad, **tkw)
        jst, jinfos = jdata.stream_rounds(
            jtr, jtr.init(jnp.zeros(n)),
            (jnp.asarray(centers[i]) for i in range(B)), step)
        tst, tinfos = stream_rounds(
            ttr, ttr.init(torch.zeros(n, dtype=torch.float64)),
            iter(centers), step)
        assert int(tst.niter) == B
        np.testing.assert_array_equal(tinfos.numpy(), np.asarray(jinfos))
        np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x),
                                   rtol=RTOL, atol=ATOL, err_msg=kind)


def test_stream_needs_a_whole_round():
    trainer = FusedTrainer("SQN", SQNConfig.create(mem_size=2,
                                                   bfgs_upd_freq=4),
                           lambda x, b: x)
    with pytest.raises(ValueError, match="fewer than upd_freq"):
        stream_rounds(trainer, trainer.init(torch.zeros(3)),
                      [np.zeros((2, 3))] * 3, 0.1)


XC_TOY = ("4 6 3\n"
          "0,2 1:0.5 4:1\n"
          "5:2.5\n"              # no labels: line starts with idx:val
          "1 0:1 2:3 3:0.25\n"
          "2,1,0 1:7\n")


def test_parse_extreme_classification(tmp_path):
    p = tmp_path / "toy_xc.txt"
    p.write_text(XC_TOY)
    X, Y = parse_extreme_classification(p)
    assert X.shape == (4, 6) and Y.shape == (4, 3) and Y.dtype == np.int8
    dense = np.zeros((4, 6))
    dense[0, 1], dense[0, 4] = 0.5, 1.0
    dense[1, 5] = 2.5
    dense[2, 0], dense[2, 2], dense[2, 3] = 1.0, 3.0, 0.25
    dense[3, 1] = 7.0
    np.testing.assert_array_equal(X.toarray(), dense)
    np.testing.assert_array_equal(
        Y, [[1, 0, 1], [0, 0, 0], [0, 1, 0], [1, 1, 1]])
    JX, JY = jdata.parse_extreme_classification(p)
    np.testing.assert_array_equal(X.toarray(), JX.toarray())
    np.testing.assert_array_equal(Y, JY)


def test_parse_extreme_classification_headerless_and_overrides(tmp_path):
    """A file without the ``n d L`` header keeps sample 0; dimensions given
    as arguments win over the header's."""
    p = tmp_path / "toy_noheader.txt"
    p.write_text("0,2 1:0.5 4:1\n"
                 "1 0:1 2:3\n")
    X, Y = parse_extreme_classification(p)
    assert X.shape == (2, 5)
    assert X[0, 1] == 0.5 and X[0, 4] == 1.0
    np.testing.assert_array_equal(Y, [[1, 0, 1], [0, 1, 0]])
    q = tmp_path / "toy_xc.txt"
    q.write_text(XC_TOY)
    X2, Y2 = parse_extreme_classification(q, n_features=9, n_labels=4)
    JX2, JY2 = jdata.parse_extreme_classification(q, n_features=9,
                                                  n_labels=4)
    assert X2.shape == JX2.shape == (4, 9) and Y2.shape == (4, 4)
    np.testing.assert_array_equal(Y2, JY2)


def test_schedules_match_jax():
    for k in range(6):
        assert schedules.step_size_sqrt(0.3, k) == \
            jschedules.step_size_sqrt(0.3, k)
        assert schedules.step_size_const(0.3, k) == 0.3


def test_metrics_match_jax():
    infos = torch.tensor([[200, 201, 200], [203, 200, 202]],
                         dtype=torch.int32)
    assert metrics.summarize_infos(infos) == \
        jmetrics.summarize_infos(infos.numpy())
    np.testing.assert_array_equal(metrics.problem_iterations(infos),
                                  jmetrics.problem_iterations(infos.numpy()))
    ours, theirs = metrics.LossHistory(tol=0.5), jmetrics.LossHistory(tol=0.5)
    for loss in (10.0, 8.0, 7.8, 9.0, 8.9):
        assert ours.update(loss) == theirs.update(loss)
    assert ours.losses == theirs.losses


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with metrics.trace(tmp_path):
        torch.ones(4) @ torch.ones(4)
    written = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert any(f.endswith((".json", ".json.gz")) for f in written), written


def test_utils_import_without_jax():
    """The port's utils are its own copies (no import of the JAX package
    even for jax-free modules); tests/test_torch_no_jax.py checks the
    whole package in a fresh process."""
    for mod in ("stochqn_tpu_torch.utils.data",
                "stochqn_tpu_torch.utils.schedules",
                "stochqn_tpu_torch.utils.metrics"):
        imports = [line.split() for line in
                   open(sys.modules[mod].__file__).read().splitlines()
                   if line.lstrip().startswith(("import ", "from "))]
        roots = {words[1].split(".")[0] for words in imports}
        assert not roots & {"jax", "jaxlib", "stochqn_tpu"}, (mod, roots)
