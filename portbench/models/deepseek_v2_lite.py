"""DeepSeek-V2-Lite's decoder, one card's share of its experts, as the
program computes it: ``stochqn_tpu_torch.models.deepseek_v2``'s loss over
the structured parameters, trained by ``PytreeTrainer``.  The benchmark's
configuration counts the experts held here in ``n_routed_experts`` and
the router's outputs in ``router_experts``; the program's configuration
counts the router's outputs in ``n_routed_experts`` and the experts held
in ``experts_held``.  The loss is looked up at each call, so a fault
planted in the program's module reaches it.

A fault of the model's own, for the readings that set the cell's limits:
:func:`top5`, the program's router keeping its top 5 experts, not 6.
"""
from __future__ import annotations

import contextlib


def batches(data: dict) -> tuple:
    """The program's epoch data: ``(ids, targets)``, leaves
    ``[num_batches, batch_size, seq_len]``."""
    return data["ids"], data["targets"]


def program_config(cfg: dict):
    from stochqn_tpu_torch.models.deepseek_v2 import DeepseekV2Config
    return DeepseekV2Config.from_dict(dict(
        cfg, n_routed_experts=cfg["router_experts"],
        experts_held=cfg["n_routed_experts"]))


def program(cfg: dict):
    """``(loss_fn(params, batch), params_template)`` for ``PytreeTrainer``:
    the template's tensors are empty (only their shapes and dtype count)."""
    import torch
    from stochqn_tpu_torch.models import deepseek_v2
    pcfg = program_config(cfg)

    def empty(tree):
        if isinstance(tree, dict):
            return {k: empty(v) for k, v in tree.items()}
        return torch.empty(tree, device="meta")

    def loss_fn(params, batch):
        return deepseek_v2.loss(params, batch, pcfg)
    return loss_fn, empty(deepseek_v2.param_shapes(pcfg))


# the program's loss, where a fault is planted
GRAD = ("stochqn_tpu_torch.models.deepseek_v2", "loss")


def half_batch(fn):
    """``fn`` on the first half of each sequence's tokens: the rest left
    out and the mean taken over what is left."""
    def loss(params, batch, cfg):
        ids, targets = batch
        h = ids.shape[-1] // 2
        return fn(params, (ids[..., :h], targets[..., :h]), cfg)
    return loss


@contextlib.contextmanager
def top5():
    """The program's router keeping the best 5 of its top 6: the sixth
    expert's weight zero while the block runs."""
    import torch
    from stochqn_tpu_torch.models import deepseek_v2
    route = deepseek_v2.route

    def five(x, router, cfg):
        idx, w = route(x, router, cfg)
        return idx, torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], 1)
    deepseek_v2.route = five
    try:
        yield
    finally:
        deepseek_v2.route = route
