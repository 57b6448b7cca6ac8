"""Multi-GPU execution: explicit SPMD over a ``(data, param)`` mesh.

Counterpart of :mod:`stochqn_tpu.parallel`; see :mod:`.mesh` for the
layout, :mod:`.evaluate` for the data-parallel sums, :mod:`.comm` for the
collectives and their recorder (the counterpart of ``hlo_stats``) and
:mod:`.distributed` for multi-process start-up.
"""
from stochqn_tpu_torch.parallel.comm import (collective_bytes,  # noqa: F401
                                             collective_ops,
                                             record_collectives)
from stochqn_tpu_torch.parallel.evaluate import (  # noqa: F401
    data_parallel_grad, data_parallel_hvp, data_parallel_value)
from stochqn_tpu_torch.parallel.mesh import (DATA_AXIS,  # noqa: F401
                                             PARAM_AXIS, MeshComm,
                                             gather_state, make_mesh,
                                             mesh_shape, shard_batches,
                                             shard_state)
