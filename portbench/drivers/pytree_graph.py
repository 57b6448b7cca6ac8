"""Fused SQN over a structured model on the single-dispatch programs:
``PytreeTrainer("SQN", ..., donate=True).jit_epochs()`` on the cell's
model (``models/<model>.py``'s ``program``: the loss over the parameters'
nested dict and its template), the Hessian-vector product ``torch.func.
jvp`` of the gradient over the round's minibatches one at a time
(``boundary_per_batch``), combined by the configuration's ``reduction``,
and one copy of the state on the card (``donate``: the state passed in
becomes the graph's buffers, and the first call's epoch is the graph's
warm-up, run in place, and no replay).

The window, the profiled slice and the check are the graph driver's
(``drivers/graph.py``): set-up makes ``check_calls`` calls as the window
makes them, keeping the iterate after each, every info code and the
pairs after the last; the plain reference replays them
(``reference/<model>.py``'s ``bind``, :mod:`portbench.reference.sqn`).
"""
from __future__ import annotations

import torch

from portbench import driving
from portbench.drivers import graph


def live_pairs(mem) -> torch.Tensor:
    """``[S; Y]`` of the live pairs, oldest first, on the host: a ring's
    (:func:`portbench.driving.live_pairs`), or an interleaved memory's in
    shift mode, whose newest pair is at rows 0-1 and ``head`` always 0."""
    if not getattr(mem, "shift", False):
        return driving.live_pairs(mem)
    rows = torch.arange(int(mem.count) - 1, -1, -1, device=mem.sy.device)
    return torch.cat([mem.s.index_select(0, rows),
                      mem.y.index_select(0, rows)]).float().cpu()


class Run(graph.Run):

    def setup(self) -> None:
        from stochqn_tpu_torch import PytreeTrainer, SQNConfig, graphs
        from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk
        cfg, tr = self.cfg, self.traffic
        self.data = self.ctx.draw()
        self.x0 = self.data["x0"]
        model = self.ctx.module("models")
        self.batches = model.batches(self.data)
        loss_fn, template = model.program(cfg)
        sqn_cfg = SQNConfig.create(
            mem_size=cfg["mem_size"], bfgs_upd_freq=cfg["bfgs_upd_freq"],
            min_curvature=cfg["min_curvature"],
            pairs_bf16=cfg.get("pairs_bf16", False),
            pairs_interleaved=cfg.get("pairs_interleaved", False))
        self.trainer = PytreeTrainer(
            "SQN", sqn_cfg, loss_fn, template, reduction=cfg["reduction"],
            donate=True, boundary_per_batch=True)
        self.program = self.trainer.jit_epochs()
        self.eta = cfg["step_size"]
        E = tr["epochs_per_call"]
        state = self.trainer.init(self.trainer.unravel(self.x0))
        xs, codes = [], []
        for _ in range(tr["check_calls"]):
            before = tlk.read_launches()
            state, infos = self.program(state, self.batches, self.eta, E)
            xs.append(state.x.detach().float().cpu())
            codes += infos.reshape(-1).tolist()
        self.state = state
        self.record = dict(xs=xs, codes=codes,
                           pairs=live_pairs(state.mem))
        per_replay = {k: (v - before[k]) / E
                      for k, v in tlk.read_launches().items()
                      if v != before[k]}
        st = graphs.STATS
        self.lines += [
            f"card: {driving.card()}",
            f"kernel launches per replay: {per_replay}",
            f"graphs: {st['captures']} captured, warm-up "
            f"{st['warm_s']:.4f} s, capture {st['capture_s']:.4f} s",
        ]
