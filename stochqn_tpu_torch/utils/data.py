"""Streaming ingestion: a host -> device pipeline for fused training.

Counterpart of :mod:`stochqn_tpu.utils.data`.  The reference streams data
through ``partial_fit`` with a host-side stored-batch container
(``stochqn/_optimizers.py:288-337``).  Here minibatches arrive from any
host iterator, are grouped into ``upd_freq``-sized rounds, staged onto the
card ahead of use (pinned host memory and ``non_blocking`` copies, so the
copy of round ``r + 1`` overlaps the work of round ``r``) and consumed by
:meth:`FusedTrainer.round <stochqn_tpu_torch.fused.FusedTrainer.round>`:
a round's batches are exactly its big batch, the reference's "all batches
since the last correction".

Batches are numpy arrays or tensors, or (nested) tuples, lists or dicts of
them, with a leading example axis.
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from stochqn_tpu_torch.core.protocol import resolve_device
from stochqn_tpu_torch.fused import _tree_map, step_like


def parse_extreme_classification(path, n_features=None, n_labels=None):
    """Parse an Extreme Classification Repository dataset file.

    The format the reference's BibTeX example reads: a header line
    ``n_points n_features n_labels``, then one line per sample of
    ``lab1,lab2,... idx:val idx:val ...``, where the label list may be
    empty (the line starts with ``idx:val`` pairs).  A plain tokenizer,
    no ``eval`` of file contents.  A first line that is not exactly three
    integers is data.  Returns ``(X_csr [n, n_features], Y [n, n_labels]
    int8)``, with the dimensions from the header unless given.
    """
    from scipy.sparse import csr_matrix

    rows, cols, vals = [], [], []
    label_rows, label_cols = [], []
    count = 0

    def consume(parts):
        nonlocal count
        start = 0
        if ":" not in parts[0]:
            for lab in parts[0].split(","):
                if lab:
                    label_rows.append(count)
                    label_cols.append(int(lab))
            start = 1
        for tok in parts[start:]:
            k, _, v = tok.partition(":")
            rows.append(count)
            cols.append(int(k))
            vals.append(float(v))
        count += 1

    with open(path, "rt") as f:
        first = f.readline().split()
        is_header = (len(first) == 3
                     and all(t.lstrip("-").isdigit() for t in first))
        if is_header:
            if n_features is None:
                n_features = int(first[1])
            if n_labels is None:
                n_labels = int(first[2])
        elif first:
            consume(first)
        for line in f:
            parts = line.split()
            if parts:
                consume(parts)
    if n_features is None:
        n_features = max(cols) + 1 if cols else 0
    if n_labels is None:
        n_labels = max(label_cols) + 1 if label_cols else 0
    X = csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                   shape=(count, n_features))
    Y = np.zeros((count, n_labels), np.int8)
    Y[label_rows, label_cols] = 1
    return X, Y


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Stage host batches onto ``device`` ``size`` batches ahead.

    ``device`` defaults to the card (none: raises; pass ``device="cpu"``
    for the CPU).  To the card a leaf is copied into pinned host memory
    and from there with ``non_blocking=True``, so the copies overlap the
    device's work and the host never waits for them; to the CPU it is
    copied.  Either way the caller may refill its arrays once a batch has
    been yielded ahead of it.
    """
    device = resolve_device(device, "prefetch_to_device")
    to_card = device.type == "cuda"

    def put_leaf(a):
        t = torch.as_tensor(a)
        if to_card and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device, copy=True)

    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(_tree_map(put_leaf, batch))
    while queue:
        out = queue.popleft()
        for batch in itertools.islice(it, 1):
            queue.append(_tree_map(put_leaf, batch))
        yield out


def rounds_of(iterator: Iterable, upd_freq: int) -> Iterator:
    """Group a minibatch stream into stacked rounds of ``upd_freq``
    batches (leaves ``[upd_freq, bs, ...]``: numpy leaves stay numpy,
    tensors are stacked where they are); drops a ragged tail."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)

    it = iter(iterator)
    while True:
        chunk = list(itertools.islice(it, upd_freq))
        if len(chunk) < upd_freq:
            return
        yield _tree_map(stack, *chunk)


def stream_rounds(trainer, state, batch_iterator: Iterable, step_size,
                  prefetch: int = 2):
    """Consume a host minibatch stream with the fused engine.

    Args:
      trainer: a :class:`stochqn_tpu_torch.fused.FusedTrainer`.
      state: its state (``niter`` a multiple of ``upd_freq``, as for a
        fresh state or between rounds), consumed.
      batch_iterator: yields minibatches (leaves ``[bs, ...]``), numpy or
        tensors; each round goes to the state's device through
        :func:`prefetch_to_device`.
      step_size: a float, or a callable ``f(round_index) -> float``.

    Returns ``(state, infos)`` with ``infos`` concatenated over all
    consumed iterations.  Nothing is read from the device.
    """
    upd_freq = trainer.cfg.upd_freq
    infos = []
    stream = prefetch_to_device(rounds_of(batch_iterator, upd_freq),
                                size=prefetch, device=state.x.device)
    for r, round_data in enumerate(stream):
        eta = step_size(r) if callable(step_size) else step_size
        state, info = trainer.round(state, round_data,
                                    step_like(eta, state.x))
        infos.append(info)
    if not infos:
        raise ValueError(
            f"stream yielded fewer than upd_freq={upd_freq} batches")
    return state, torch.cat(infos)
