"""The benchmark of ``stochqn_tpu_torch`` on the card: ``run.py`` runs one
cell of ``BENCHMARK.json`` (see ``harness.py``); ``control.py`` takes the
readings its checks' limits are set from; ``tests/`` holds its own tests.
It imports nothing of JAX or of the JAX package."""
