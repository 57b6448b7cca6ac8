"""DeepSeek-V2's decoder on the pytree path
(:mod:`stochqn_tpu_torch.models.deepseek_v2`), against the benchmark's
plain reference (``portbench/reference/deepseek_v2_lite.py``, which
imports nothing of the port), at a tiny size on the CPU in float64:
hidden 64, 2 heads, ``kv_lora_rank`` 16, rope 8, nope 16, v 16, 8 of 16
routed experts held, top 3, sequences of 32 over a 128-id slice.

The loss, the gradient and the jvp Hessian-vector product against the
reference's double backward; routing that sends every token to one held
expert; the expert shares adding up to the uncut layer; fused SQN epochs
of ``PytreeTrainer.jit_epochs`` against the plain SQN
(``portbench/reference/sqn.py``); the boundary one minibatch at a time
against the merged batch, for a summed loss and for the model's mean
loss; the donated programs (one copy of the state: the state passed in
becomes the buffers, and the warm-up is the first call's epoch) against
the eager loop through the graph driver's stand-in; the commit's Gram
columns over a bfloat16 buffer taken in chunks.

No JAX: the port is held to the plain reference here.
"""
import numpy as np
import pytest
import torch

from portbench.reference import deepseek_v2_lite as ref
from portbench.reference import sqn as ref_sqn
from stochqn_tpu_torch import (AdaQNConfig, FusedTrainer, OLBFGSConfig,
                               PytreeTrainer, SQNConfig, graphs)
from stochqn_tpu_torch.models import deepseek_v2 as ds
from stochqn_tpu_torch.models import losses
from stochqn_tpu_torch.models.losses import hvp_from_grad
from stochqn_tpu_torch.ops import pairs
from stochqn_tpu_torch.optim_adapter import _leaves, _ravel
from stochqn_tpu_torch.utils import metrics
import torch_dist_worker as tw

F64 = torch.float64
T, V = 32, 128
# the reference's configuration: n_routed_experts held, router_experts the
# router's outputs
CFG = dict(hidden_size=64, num_attention_heads=2, kv_lora_rank=16,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           intermediate_size=96, moe_intermediate_size=24, router_experts=16,
           n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=3,
           routed_scaling_factor=1.0, first_k_dense_replace=1,
           num_hidden_layers=3, vocab_size=V, rms_norm_eps=1e-6,
           rope_theta=10000.0, q_lora_rank=None, topk_method="greedy",
           norm_topk_prob=False,
           rope_scaling=dict(type="yarn", factor=40,
                             original_max_position_embeddings=4096,
                             beta_fast=32, beta_slow=1, mscale=0.707,
                             mscale_all_dim=0.707))


def _pcfg(cfg=CFG):
    """The program's configuration of a reference configuration."""
    return ds.DeepseekV2Config.from_dict(dict(
        cfg, n_routed_experts=cfg["router_experts"],
        experts_held=cfg["n_routed_experts"]))


def _params(seed, std=0.3, cfg=CFG):
    g = torch.Generator().manual_seed(seed)
    return ds.init_params(_pcfg(cfg), g, dtype=F64, std=std)


def _tokens(seed, batches, bs=1):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, V, (batches, bs, T + 1), generator=g)
    return tok[..., :-1].contiguous(), tok[..., 1:].contiguous()


def _trainer(params, **kw):
    pcfg = _pcfg()
    return PytreeTrainer("SQN", SQNConfig.create(mem_size=3, bfgs_upd_freq=2),
                         lambda p, b: ds.loss(p, b, pcfg), params,
                         reduction="mean", **kw)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_layout_matches_the_reference():
    params = _params(0)
    assert [tuple(t.shape) for t in _leaves(params)] == \
        [s for _, s in ref.layout(CFG)]
    assert _ravel(params).numel() == ref.size(CFG)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_gradient_and_hvp_match_the_reference(seed):
    params = _params(seed)
    x = _ravel(params)
    ids, tgt = _tokens(seed, 1)
    tr = _trainer(params)
    batch = (ids[0], tgt[0])
    want = ref.loss(ref.split(x, CFG), ids[0], tgt[0], CFG)
    got = ds.loss(tr.unravel(x), batch, _pcfg())
    assert abs(float(got - want)) <= 1e-10 * abs(float(want))
    g = tr.trainer.grad_fn(x, batch)
    assert _rel(g, ref.gradient(x, ids[0], tgt[0], CFG)) <= 1e-10
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(9),
                    dtype=F64)
    hv = hvp_from_grad(tr.trainer.grad_fn)(x, v, batch)
    assert _rel(hv, ref.hessvec(x, v, ids[0], tgt[0], CFG)) <= 1e-10


def test_routing_every_token_to_one_held_expert_drops_none():
    pcfg = _pcfg()
    p = _params(2)["layers"]["01"]["moe"]
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 5] = 50.0            # expert 5 first for every token
    x = torch.randn(T, CFG["hidden_size"], dtype=F64,
                    generator=torch.Generator().manual_seed(3)).abs()
    metrics.reset()
    got = ds._moe(p, x, pcfg, 0)
    P = {f"{k}/{kk}" if isinstance(v, dict) else k: vv
         for k, v in p.items()
         for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)])}
    want = ref.moe(P, x, CFG)
    assert _rel(got, want) <= 1e-12
    counts = metrics.snapshot()["device_counters"]["expert_tokens"][0]
    assert counts[5] == T and sum(counts) == T * CFG["num_experts_per_tok"]
    idx, w = ds.route(x, p["router"], pcfg)
    assert bool((idx[:, 0] == 5).all())
    # expert 5's part: every token through it, at its gate weight
    e = p["experts"]
    alone = ds._silu(x @ e["gate"][5]) * (x @ e["up"][5]) @ e["down"][5]
    rest = ref.moe(P, x, dict(CFG, n_routed_experts=5))
    torch.testing.assert_close(got - rest, w[:, :1] * alone, rtol=1e-10,
                               atol=1e-12)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two cards of 8 experts each: the first holds ids 0-7, the second
    (its router's columns and experts relabelled) ids 8-15.  Their routed
    parts, with the shared experts counted once, make the layer that
    holds all 16."""
    pcfg = _pcfg()
    p = _params(4)["layers"]["01"]["moe"]
    g = torch.Generator().manual_seed(5)
    full = {k: torch.randn((16,) + tuple(t.shape[1:]), generator=g,
                           dtype=F64) * 0.3
            for k, t in p["experts"].items()}
    x = torch.randn(T, CFG["hidden_size"], dtype=F64, generator=g)
    first = dict(p, experts={k: t[:8] for k, t in full.items()})
    order = torch.cat([torch.arange(8, 16), torch.arange(0, 8)])
    second = dict(p, router=p["router"][:, order],
                  experts={k: t[8:] for k, t in full.items()})
    shared = ds._mlp(p["shared"], x)
    parts = ds._moe(first, x, pcfg, None) + ds._moe(second, x, pcfg, None) \
        - shared
    P = {"router": p["router"], **{f"shared/{k}": t
                                   for k, t in p["shared"].items()},
         **{f"experts/{k}": t for k, t in full.items()}}
    uncut = ref.moe(P, x, dict(CFG, n_routed_experts=16))
    assert _rel(parts, uncut) <= 1e-12


def _sqn_reference(x0, ids, tgt, steps, eta):
    """The plain SQN over the reference's gradient and Hessian-vector
    product (each round's minibatches averaged)."""
    B, L = ids.shape[0], 2
    opt = ref_sqn.SQN(x0.clone(), 3, L, 1e-4)

    def grad(x, t):
        return ref.gradient(x, ids[t % B], tgt[t % B], CFG)

    def hessvec(x, v, r):
        r %= B // L
        return sum(ref.hessvec(x, v, ids[b], tgt[b], CFG)
                   for b in range(r * L, (r + 1) * L)) / L
    events = ref_sqn.run(opt, steps, grad, hessvec, lambda t: eta)
    return opt, ref_sqn.fused_codes(events)


def test_fused_sqn_epochs_match_the_plain_sqn():
    params = _params(6, std=0.05)
    ids, tgt = _tokens(6, 4)
    tr = _trainer(params, donate=True, boundary_per_batch=True)
    state = tr.init()
    x0 = state.x.clone()
    state, infos = tr.jit_epochs()(state, (ids, tgt), 0.05, 2)
    opt, codes = _sqn_reference(x0, ids, tgt, 8, 0.05)
    assert infos.reshape(-1).tolist() == codes
    assert _rel(state.x - x0, opt.x - x0) <= 1e-10
    assert int(state.mem.count) == len(opt.S) > 0


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _logistic(rng, **kw):
    F, K = 5, 3
    X = torch.from_numpy(rng.standard_normal((4, 6, F)))
    Y = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, K, (4, 6))), K).to(F64)

    def grad(x, b):         # a sum over the rows, no penalty outside it
        return losses.multinomial_logistic_grad(x, b[0], b[1], None, 0.0)
    tr = FusedTrainer("SQN", SQNConfig.create(mem_size=3, bfgs_upd_freq=2),
                      grad, **kw)
    return tr, (X, Y), torch.from_numpy(rng.standard_normal(K * (F + 1)))


@pytest.mark.parametrize("generic", [False, True])
def test_boundary_per_batch_equals_the_merged_batch_summed(rng, generic):
    merged, data, x0 = _logistic(rng)
    each, _, _ = _logistic(np.random.default_rng(11), boundary_per_batch=True)
    a, ia = merged.epochs(merged.init(x0), data, 0.05, 3,
                          aligned=False if generic else None)
    b, ib = each.epochs(each.init(x0), data, 0.05, 3,
                        aligned=False if generic else None)
    assert torch.equal(ia, ib) and int(a.mem.count) > 0
    torch.testing.assert_close(b.x, a.x, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(b.mem.y, a.mem.y, rtol=1e-12, atol=1e-12)


def test_boundary_per_batch_equals_the_merged_batch_mean():
    params = _params(7, std=0.05)
    ids, tgt = _tokens(7, 4, bs=2)
    a, ia = _trainer(params).run_epochs(_trainer(params).init(), (ids, tgt),
                                        1, 0.05)
    tr = _trainer(params, boundary_per_batch=True)
    b, ib = tr.run_epochs(tr.init(), (ids, tgt), 1, 0.05)
    assert torch.equal(ia, ib) and int(a.mem.count) > 0
    assert _rel(b.mem.y, a.mem.y) <= 1e-10
    assert _rel(b.x, a.x) <= 1e-12


def test_options_are_checked():
    def grad(x, b):
        return x
    with pytest.raises(ValueError, match="boundary_per_batch"):
        FusedTrainer("adaQN", AdaQNConfig.create(max_incr=None), grad,
                     boundary_per_batch=True)
    with pytest.raises(ValueError, match="boundary_per_batch"):
        FusedTrainer("oLBFGS", OLBFGSConfig.create(), grad,
                     boundary_per_batch=True)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", tw.ReplayedGraph)
    monkeypatch.setattr(graphs, "captures", lambda state: True)
    graphs.reset_stats()


@pytest.mark.parametrize("shared", [False, True])
def test_donated_state_is_the_buffers_and_its_warm_up_an_epoch(
        rng, replayed, shared):
    """With ``donate`` the state passed in becomes the graph's buffers and
    the warm-up is the first epoch; a tensor whose storage another holds
    (``shared``) gets a buffer of its own, and the epochs are the same."""
    eager, data, x0 = _logistic(rng)
    want, wi = eager.epochs(eager.init(x0), data, 0.05, 3)
    lean, _, _ = _logistic(np.random.default_rng(11), donate=True)
    state = lean.init(x0)
    if shared:      # two zero fields held by one tensor
        state = state.replace(x_avg_prev=state.grad_prev)
    leaves = graphs.flatten(state)[0]
    got, gi = lean.jit_epochs()(state, data, 0.05, 3)
    fam = next(iter(lean._programs.families.values()))
    held = [graphs._storage(t) for t in leaves]
    again = [k in held[:i] for i, k in enumerate(held)]
    assert any(again) == shared
    assert [a is b for a, b in zip(fam.state, leaves)] == \
        [not a for a in again]
    (graph,) = lean._programs.graphs()
    assert graph.replays == 2 and graph.pending is None
    assert torch.equal(gi, wi)
    assert all(torch.equal(a, b) for a, b in zip(graphs.flatten(got)[0],
                                                  graphs.flatten(want)[0]))


@pytest.mark.parametrize("n", [1000, 1001])
def test_gram_columns_in_chunks(monkeypatch, n):
    g = torch.Generator().manual_seed(n)
    buf = torch.randn(6, n, generator=g).to(torch.bfloat16)
    rs, ry = (torch.randn(n, generator=g).to(torch.bfloat16)
              for _ in range(2))
    whole = pairs._gram_cols(buf, rs, ry, torch.float32)
    monkeypatch.setattr(pairs, "UPCAST_CHUNK_BYTES", 6 * 4 * 64)
    chunked = pairs._gram_cols(buf, rs, ry, torch.float32)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-4)
