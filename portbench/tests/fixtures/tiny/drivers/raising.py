"""A driver for the launcher's tests: each rank writes its process id
into the directory ``PORTBENCH_TEST_PIDS`` names, then rank 1 raises
while the others wait for it at a barrier that never completes."""
from __future__ import annotations

import os
from pathlib import Path

from portbench import driving


class Run(driving.Base):
    def setup(self) -> None:
        ranks = self.ctx.ranks
        Path(os.environ["PORTBENCH_TEST_PIDS"], f"r{ranks.rank}").write_text(
            str(os.getpid()))
        if ranks.rank == 1:
            raise RuntimeError("rank 1 fails in its set-up")
        ranks.barrier()
