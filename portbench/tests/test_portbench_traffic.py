"""The seeded data generators."""
import json

import pytest
import torch

from portbench import harness


def _cfg(tiny, name):
    return tiny.config(name)


@pytest.mark.parametrize("config", ["tiny_dense", "tiny_sparse"])
def test_same_seed_same_data(tiny, config):
    cfg = _cfg(tiny, config)
    gen = tiny.module("data", cfg["data"])
    a, b = gen.make(cfg, 2**31 + 99, "cpu"), gen.make(cfg, 2**31 + 99, "cpu")
    c = gen.make(cfg, 7, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].dtype.is_floating_point
               and a[k].abs().sum() > 0)


def test_dense_shapes(tiny):
    cfg = _cfg(tiny, "tiny_dense")
    d = tiny.module("data", "dense_gaussian").make(cfg, 3, "cpu")
    B, bs, F, K = (cfg[k] for k in ("num_batches", "batch_size",
                                    "n_features", "n_classes"))
    assert d["X"].shape == (B, bs, F) and d["Y"].shape == (B, bs, K)
    assert torch.equal(d["Y"].sum(-1), torch.ones(B, bs))
    assert d["x0"].shape == (K * (F + 1),)


def test_criteo_rows_have_39_nonzeros_padded_to_40():
    cfg = json.loads((harness.HERE / "configs" / "criteo_sqn.json")
                     .read_text())
    cfg = dict(cfg, num_batches=2, batch_size=64)
    d = harness.Bench().module("data", cfg["data"]).make(cfg, 2**31 + 5,
                                                          "cpu")
    idx, val = d["idx"], d["val"]
    assert idx.shape == (2, 64, 40) and idx.dtype == torch.int64
    assert torch.equal((val != 0).sum(-1), torch.full((2, 64), 39))
    assert torch.equal(val[..., 39], torch.zeros(2, 64))
    assert torch.equal(idx[..., 39], torch.zeros(2, 64, dtype=torch.int64))
    assert int(idx.min()) >= 0 and int(idx.max()) < cfg["n_features"]
    assert torch.equal(val[..., 13:39], torch.ones(2, 64, 26))
    assert set(d["y"].unique().tolist()) <= {-1.0, 1.0}
