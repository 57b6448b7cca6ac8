"""SQN in free mode: one user's own loop over ``SQN_free.run_optimizer``,
the reference's request protocol (the loop of
``examples/torch/rosenbrock_free_mode.py``), closed: the next call waits
for the last reply.

``x`` is a float32 numpy array that each call writes the iterate into.
The user answers ``calc_grad`` with the program's gradient on the next
minibatch in turn and ``calc_hess_vec`` with its Hessian-vector product on
the round's minibatches merged, both on the card from the requested
point copied there, and hands the result over as a card tensor.

Set-up makes the first call and answers requests until ``check_epochs``
epochs of iterations have run, keeping the iterate at each epoch's end,
every request and code, and the pairs after the last.  The window goes on
with the same loop until ``--seconds`` have passed: ``free_iters_per_s``
is the iterations it completed over its seconds, ``free_call_p95_us`` the
95th percentile of the host wall of every ``run_optimizer`` call in it.
The profiled slice is ``trace_calls`` more calls after the window.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import driving
from portbench.reference import sqn as ref_sqn


class Run(driving.Base):
    program_attrs = ("opt",)

    def setup(self) -> None:
        from stochqn_tpu_torch import SQN_free
        cfg = self.cfg
        self.data = self.ctx.draw()
        self.x0 = self.data["x0"]
        model = self.ctx.module("models")
        self.batches = model.batches(self.data)
        self.grad_fn, self.hess_vec_fn = model.program(cfg)
        B, L = cfg["num_batches"], cfg["bfgs_upd_freq"]
        self.rounds = B // L
        self.opt = SQN_free(mem_size=cfg["mem_size"], bfgs_upd_freq=L,
                            min_curvature=cfg["min_curvature"],
                            pairs_bf16=cfg.get("pairs_bf16", False),
                            use_float=True, device=self.device)
        self.eta = cfg["step_size"]
        self.x = self.x0.cpu().numpy().copy()
        self.answered = 0               # calc_grad requests answered
        self.walls: list = []
        self.req = self.opt.run_optimizer(self.x, self.eta)
        xs, tasks, codes = [], [], []
        for e in range(1, self.traffic["check_epochs"] + 1):
            # an epoch is B calls and one per later boundary; a program
            # that does not advance stops there
            for _ in range(B + self.rounds):
                if self.opt.niter >= e * B and \
                        self.req["task"] == "calc_grad":
                    break
                self.call()
                tasks.append(self.req["task"])
                codes.append(driving.NAMES[self.req["info"]["iteration_info"]])
            xs.append(torch.from_numpy(self.x.copy()))
        self.record = dict(xs=xs, tasks=tasks, codes=codes,
                           pairs=driving.live_pairs(self.opt.state.mem))
        self.lines.append(f"card: {driving.card()}")

    def _to_card(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def call(self) -> None:
        """Answer the pending request, then make the next call."""
        req = self.req
        if req["task"] == "calc_grad":
            b = self.answered % self.cfg["num_batches"]
            self.answered += 1
            self.opt.update_gradient(self.grad_fn(
                self._to_card(req["requested_on"]),
                tuple(t[b] for t in self.batches)))
        else:                                   # calc_hess_vec
            L = self.cfg["bfgs_upd_freq"]
            r = (req["info"]["iteration_number"] // L - 1) % self.rounds
            big = tuple(t[r * L:(r + 1) * L].reshape((-1,) + t.shape[2:])
                        for t in self.batches)
            x_avg, s = req["requested_on"]
            self.opt.update_hess_vec(self.hess_vec_fn(
                self._to_card(x_avg), self._to_card(s), big))
        t0 = self.clock()
        self.req = self.opt.run_optimizer(self.x, self.eta)
        self.walls.append(self.clock() - t0)

    def window(self, seconds: float) -> None:
        start, calls = self.opt.niter, len(self.walls)
        failed = 0
        t0 = self.clock()
        while True:
            with torch.profiler.record_function("portbench.user_loop"):
                self.call()
            failed += self.req["info"]["iteration_info"] == \
                "search_direction_was_nan"
            if self.clock() - t0 >= seconds:
                break
        self.window_s = self.clock() - t0
        walls = np.array(self.walls[calls:])
        self.attempted, self.failed = self.opt.niter - start, failed
        self.call_share = float(walls.sum()) / self.window_s
        self.rate = len(walls) / self.window_s            # calls a second
        self.end_to_end = {
            "free_iters_per_s": self.attempted / self.window_s,
            "free_call_p95_us": float(np.percentile(walls, 95)) * 1e6}
        self.lines.append(f"window: {len(walls)} run_optimizer calls, "
                          f"{self.attempted} iterations")

    def trace(self) -> None:
        def calls():
            for _ in range(self.traffic["trace_calls"]):
                with torch.profiler.record_function("portbench.user_loop"):
                    self.call()
        self.profile(calls)
        self.traced["work"] = self.traffic["trace_calls"]

    def reference(self, mode: str) -> dict:
        cfg, B = self.cfg, self.cfg["num_batches"]
        bind = self.ctx.module("reference").bind
        self.loss = bind(cfg, self.data, torch.float32)[2]
        with driving.precision(mode) as dtype:
            grad, hessvec, _ = bind(cfg, self.data, dtype)
            opt = ref_sqn.SQN(self.x0.to(dtype), cfg["mem_size"],
                              cfg["bfgs_upd_freq"], cfg["min_curvature"])
            xs, calls = [], []
            for e in range(self.traffic["check_epochs"]):
                events = ref_sqn.run(opt, B, grad, hessvec,
                                     lambda t: self.eta, start=e * B)
                xs.append(opt.x.float().cpu())
                calls += ref_sqn.protocol_calls(events)
            return dict(xs=xs, tasks=[t for t, _ in calls],
                        codes=[c for _, c in calls],
                        pairs=driving.reference_pairs(opt))
