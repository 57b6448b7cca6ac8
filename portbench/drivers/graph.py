"""Fused SQN on the single-dispatch programs: ``FusedTrainer("SQN",
hess_vec_fn=..., donate=True).jit_epochs()`` over the fixed batched data,
call after call, each call ``epochs_per_call`` epochs (one CUDA-graph
replay an epoch on the card).

Set-up builds the trainer and its state and makes the first
``check_calls`` calls exactly as the window makes them, ``epochs_per_call``
epochs each through the same program (its graph captured at the first),
keeping the iterate after each call, every iteration's info code and the
pairs after the last; the launch counters are read over the last.  The
window goes on from that state, calling until ``--seconds`` have passed,
with one call in flight behind the one the host waits for; it ends at the
host's wait for the last call.  ``iters_per_s``: the iterations the
program counted in its state (``niter``) over the window, over its
seconds.  The profiled slice is ``trace_calls`` more calls after the
window.

Where the traffic names a ``mesh`` ``[n_data, n_param]``, the cell runs
as that many ranks (``portbench/ranks.py``): each draws the same data
from the seed on its own card, the trainer runs on the port's mesh
(``FusedTrainer(..., mesh=...)``, ``init`` shards ``x0``), the checked
iterates and pairs are gathered from every rank's part
(``parallel.mesh.gather_state``), and rank 0's clock ends the window.
"""
from __future__ import annotations

import torch

from portbench import driving
from portbench.reference import sqn as ref_sqn


class Run(driving.Base):
    program_attrs = ("trainer", "program", "state")

    def setup(self) -> None:
        from stochqn_tpu_torch import FusedTrainer, SQNConfig, graphs
        from stochqn_tpu_torch.parallel.mesh import gather_state
        from stochqn_tpu_torch.ops.kernels import two_loop_kernel as tlk
        cfg, tr = self.cfg, self.traffic
        self.data = self.ctx.draw()
        self.x0 = self.data["x0"]
        model = self.ctx.module("models")
        self.batches = model.batches(self.data)
        grad_fn, hess_vec_fn = model.program(cfg)
        sqn_cfg = SQNConfig.create(
            mem_size=cfg["mem_size"], bfgs_upd_freq=cfg["bfgs_upd_freq"],
            min_curvature=cfg["min_curvature"],
            pairs_bf16=cfg.get("pairs_bf16", False))
        mesh = self.ctx.mesh(tr["mesh"]) if "mesh" in tr else None
        self.trainer = FusedTrainer("SQN", sqn_cfg, grad_fn,
                                    hess_vec_fn=hess_vec_fn, mesh=mesh,
                                    donate=True)
        self.program = self.trainer.jit_epochs()
        self.eta = cfg["step_size"]
        E = tr["epochs_per_call"]
        state = self.trainer.init(self.x0.clone())
        xs, codes = [], []
        for _ in range(tr["check_calls"]):
            before = tlk.read_launches()
            state, infos = self.program(state, self.batches, self.eta, E)
            full = state if mesh is None else gather_state(state, mesh)
            xs.append(full.x.detach().float().cpu())
            codes += infos.reshape(-1).tolist()
        self.state = state
        self.record = dict(xs=xs, codes=codes,
                           pairs=driving.live_pairs(full.mem))
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

    def window(self, seconds: float) -> None:
        E = self.traffic["epochs_per_call"]
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        start, prev = int(self.state.niter), None
        t0 = self.clock()
        while True:
            with torch.profiler.record_function("portbench.jit_epochs"):
                self.state, infos = self.program(self.state, self.batches,
                                                 self.eta, E)
            bad += (infos == driving.NAN_CODE).sum()
            ev = self.marker()
            if prev is not None:
                prev.synchronize()
            prev = ev
            if self.stop(self.clock() - t0 >= seconds):
                break
        self.sync()
        self.window_s = self.clock() - t0
        self.attempted = int(self.state.niter) - start
        self.failed = int(bad)
        self.rate = self.attempted / self.window_s
        self.end_to_end = {"iters_per_s": self.rate}

    def trace(self) -> None:
        E, calls = self.traffic["epochs_per_call"], self.traffic["trace_calls"]

        def call():
            for _ in range(calls):
                with torch.profiler.record_function("portbench.jit_epochs"):
                    self.state, _ = self.program(self.state, self.batches,
                                                 self.eta, E)
        self.profile(call)
        self.traced["work"] = calls * E * self.cfg["num_batches"]

    def reference(self, mode: str) -> dict:
        cfg, tr = self.cfg, self.traffic
        steps = tr["epochs_per_call"] * cfg["num_batches"]
        bind = self.ctx.module("reference").bind
        self.loss = bind(cfg, self.data, torch.float32)[2]
        with driving.precision(mode) as dtype:
            grad, hessvec, _ = bind(cfg, self.data, dtype)
            opt = ref_sqn.SQN(self.x0.to(dtype), cfg["mem_size"],
                              cfg["bfgs_upd_freq"], cfg["min_curvature"])
            xs, codes = [], []
            for c in range(tr["check_calls"]):
                events = ref_sqn.run(opt, steps, grad, hessvec,
                                     lambda t: self.eta, start=c * steps)
                xs.append(opt.x.float().cpu())
                codes += ref_sqn.fused_codes(events)
            return dict(xs=xs, codes=codes,
                        pairs=driving.reference_pairs(opt))
