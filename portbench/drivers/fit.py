"""Repeated whole fits of the scikit-learn-style model, as a user who
fits many models runs them (a grid over ``reg_grid``):
``StochasticLogisticRegression(optimizer="SQN", engine="fused", ...)
.fit(X, y)`` on a float64 numpy ``X`` and one-hot ``y``.

Fit ``i`` (from 0) takes ``random_state = (seed + i) mod 2**32`` and
``reg_param = reg_grid[i mod len(reg_grid)]``; every fit does the same
work: ``nepochs`` epochs of ``batches_per_epoch`` batches, shuffled, no
validation split.  Set-up draws the data on the card, copies it to the
host as the user holds it and makes ``warm_fits`` fits.  The window fits
until ``--seconds`` have passed (``fits_per_s``: the fits completed over
its seconds) and keeps every fit's coefficients.  The profiled slice is
one more fit after the window.

The check takes one of the window's fits for each penalty of the grid,
drawn from the seed, and fits each again with the plain reference: the same start drawn from
``random_state`` as the model draws it, the same row order each epoch
(``torch.randperm`` from a generator on the card seeded with
``random_state``), the same step schedule ``step_size / sqrt(epoch +
1)``.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from portbench import checks, driving
from portbench.reference import losses as ref_losses
from portbench.reference import sqn as ref_sqn


class Run(driving.Base):
    program_attrs = ()

    def setup(self) -> None:
        from stochqn_tpu_torch import graphs
        self.data = self.ctx.draw()
        F, K = self.cfg["n_features"], self.cfg["n_classes"]
        self.X = self.data["X"].reshape(-1, F).double().cpu().numpy()
        self.Y = self.data["Y"].reshape(-1, K).double().cpu().numpy()
        self.fits: list = []                     # (index, x_) of the window's
        self.index = 0
        for _ in range(self.traffic["warm_fits"]):
            self.fit()
        self.sync()
        st = graphs.STATS
        self.lines += [f"card: {driving.card()}",
                       f"graphs after {self.index} fits: {st['captures']} "
                       f"captured, warm-up {st['warm_s']:.4f} s, capture "
                       f"{st['capture_s']:.4f} s, launches by replays "
                       f"{st['replay_launches']}"]

    def fit_args(self, i: int):
        tr = self.traffic
        return ((self.ctx.seed + i) % 2 ** 32,
                tr["reg_grid"][i % len(tr["reg_grid"])])

    def fit(self) -> np.ndarray:
        from stochqn_tpu_torch import StochasticLogisticRegression
        tr, cfg = self.traffic, self.cfg
        rs, reg = self.fit_args(self.index)
        model = StochasticLogisticRegression(
            reg_param=reg, random_state=rs, optimizer="SQN", engine="fused",
            step_size=cfg["step_size"], valset_frac=None,
            nepochs=tr["nepochs"], batches_per_epoch=cfg["num_batches"],
            shuffle_data=True, mem_size=cfg["mem_size"],
            bfgs_upd_freq=cfg["bfgs_upd_freq"],
            min_curvature=cfg["min_curvature"], device=self.device)
        model.fit(self.X, self.Y)
        self.index += 1
        return model.x_

    def window(self, seconds: float) -> None:
        from stochqn_tpu_torch import graphs
        s0 = dict(graphs.STATS)
        failed = 0
        t0 = self.clock()
        while True:
            with torch.profiler.record_function("portbench.fit"):
                i = self.index
                x = self.fit()
            failed += not np.isfinite(x).all()
            self.fits.append((i, x))
            if self.clock() - t0 >= seconds:
                break
        self.window_s = self.clock() - t0
        st = graphs.STATS
        n = len(self.fits)
        self.attempted, self.failed = n, int(failed)
        self.capture_s = (st["warm_s"] - s0["warm_s"]
                          + st["capture_s"] - s0["capture_s"])
        self.end_to_end = {"fits_per_s": n / self.window_s}
        self.lines.append(f"window: {n} fits, {st['captures'] - s0['captures']}"
                          f" graphs captured")

    def trace(self) -> None:
        def one():
            with torch.profiler.record_function("portbench.fit"):
                self.fit()
        self.profile(one)

    # -- the check --------------------------------------------------------- #
    def sample(self) -> list:
        """One of the window's fits for each value of ``reg_grid``, drawn
        from the seed: the smallest penalty moves the iterate furthest
        from where the penalty alone takes it, the largest least."""
        rng = random.Random(self.ctx.seed)
        grid = len(self.traffic["reg_grid"])
        by_reg = [[f for f in self.fits if f[0] % grid == g]
                  for g in range(grid)]
        return [rng.choice(fits) for fits in by_reg if fits]

    def reference_fit(self, i: int, mode: str) -> tuple:
        """The fit ``i`` by the plain reference: ``(x0, x, loss)``."""
        cfg, tr = self.cfg, self.traffic
        rs, reg = self.fit_args(i)
        dev = self.device
        B, bs, L = cfg["num_batches"], cfg["batch_size"], cfg["bfgs_upd_freq"]
        F, K = cfg["n_features"], cfg["n_classes"]
        np.random.seed(rs)
        x0 = torch.as_tensor(np.random.normal(size=K * (F + 1)),
                             dtype=torch.float32, device=dev)
        X = torch.as_tensor(self.X, dtype=torch.float32, device=dev)
        Y = torch.as_tensor(self.Y, dtype=torch.float32, device=dev)
        rows = X.shape[0]
        w = torch.full((rows,), 1.0 / rows, dtype=torch.float64,
                       device=dev).float()

        def loss(x):
            return float(ref_losses.multinomial_loss(
                x.to(dev).double(), X.double(), Y.double(), w.double(), reg))
        gen = torch.Generator(device=dev)
        gen.manual_seed(rs)
        with driving.precision(mode) as dtype:
            opt = ref_sqn.SQN(x0.to(dtype), cfg["mem_size"], L,
                              cfg["min_curvature"])
            for e in range(tr["nepochs"]):
                perm = torch.randperm(rows, generator=gen, device=dev)
                Xe = X[perm].to(dtype).reshape(B, bs, F)
                Ye = Y[perm].to(dtype).reshape(B, bs, K)
                We = w[perm].to(dtype).reshape(B, bs)
                eta = cfg["step_size"] / math.sqrt(e + 1)

                def grad(x, t):
                    b = t % B
                    return ref_losses.multinomial_grad(x, Xe[b], Ye[b],
                                                       We[b], reg)

                def hessvec(x, v, r):
                    part = slice((r % (B // L)) * L, (r % (B // L) + 1) * L)
                    return ref_losses.multinomial_hessvec(
                        x, v, Xe[part].reshape(-1, F),
                        Ye[part].reshape(-1, K), We[part].reshape(-1), reg)
                ref_sqn.run(opt, B, grad, hessvec, lambda t: eta,
                            start=e * B)
            return x0, opt.x.float().cpu(), loss

    def check(self) -> dict:
        return self.compare_sample(lambda i, x: torch.from_numpy(x))

    def control(self, mode: str) -> dict:
        return self.compare_sample(
            lambda i, x: self.reference_fit(i, mode)[1])

    def compare_sample(self, coefficients) -> dict:
        """The worst of each number over the sampled fits: the
        coefficients ``coefficients(i, x_)`` of fit ``i`` (the model's
        were ``x_``) against the reference's fit."""
        worst: dict = {}
        for i, x in self.sample():
            x0, xr, loss = self.reference_fit(i, "float32")
            nums = checks.compare({"xs": [coefficients(i, x)]},
                                  {"xs": [xr]}, x0, loss)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
