"""Training a model with structured parameters by adaQN, with the PyTorch
port.

The counterpart of ``examples/pytree_mlp_adaqn.py``.
:class:`stochqn_tpu_torch.optim_adapter.PytreeTrainer` takes any
``loss_fn(params, batch)`` over a nested dict of tensors (or an
``nn.Module``'s parameters) and a template, and trains it with the fused
engine: the flat ``x`` of the optimizer is viewed back into the template
for ``loss_fn``, and the gradient is ``torch.func.grad`` of that.  A
two-layer tanh MLP on a two-moons-style binary task; adaQN with the
RMSProp-preconditioned two-loop and the ``max_incr`` guard on.

Run: python examples/torch/pytree_mlp_adaqn.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stochqn_tpu_torch import AdaQNConfig, PytreeTrainer  # noqa: E402


def make_data(dev, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    flip = rng.integers(0, 2, n)
    x = np.stack([np.cos(t) + flip * 1.0 - 0.5,
                  np.sin(t) * (1 - 2 * flip) + flip * 0.35], axis=1)
    x += rng.normal(scale=0.12, size=x.shape)
    return (torch.tensor(x, dtype=torch.float32, device=dev),
            torch.tensor(flip, dtype=torch.float32, device=dev))


def init_params(dev, hidden=32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "dense1": {"w": (torch.randn(2, hidden, generator=gen) * 0.5).to(dev),
                   "b": torch.zeros(hidden, device=dev)},
        "dense2": {"w": (torch.randn(hidden, 1, generator=gen) * 0.5).to(dev),
                   "b": torch.zeros(1, device=dev)},
    }


def forward(params, x):
    h = torch.tanh(x @ params["dense1"]["w"] + params["dense1"]["b"])
    return (h @ params["dense2"]["w"] + params["dense2"]["b"])[:, 0]


def loss_fn(params, batch):
    x, y = batch
    z = forward(params, x) * (2 * y - 1)
    return torch.mean(torch.clamp(-z, min=0) + torch.log1p(
        torch.exp(-torch.abs(z))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    x, y = make_data(dev)
    params0 = init_params(dev)

    bs, nb = 128, x.shape[0] // 128
    data = (x[:nb * bs].reshape(nb, bs, 2), y[:nb * bs].reshape(nb, bs))

    trainer = PytreeTrainer(
        "adaQN",
        AdaQNConfig.create(mem_size=10, fisher_size=50, bfgs_upd_freq=8,
                           max_incr=1.01, rmsprop_weight=0.9),
        loss_fn, params0)
    state = trainer.init()

    print(f"initial loss: {float(loss_fn(params0, (x, y))):.4f}")
    for epoch in range(12):
        # run_epochs returns the new state (on the card one CUDA-graph
        # replay per epoch): rebind to it
        state, _ = trainer.run_epochs(state, data, 1, step_size=0.1)
        params = trainer.params(state)
        loss = float(loss_fn(params, (x, y)))
        acc = float(((forward(params, x) > 0) == (y > 0)).float().mean())
        print(f"epoch {epoch + 1:2d}: loss {loss:.4f}  acc {acc:.3f}")

    assert acc > 0.9, "did not learn the moons"
    print("done: structured parameters trained by the fused adaQN engine")


if __name__ == "__main__":
    main()
