"""Device-resident replay window — the port of
alphazero_general_tpu/selfplay/device_window.py.

Each iteration's raw samples are uploaded to the device once, into a
fixed-size ring of tensors (obs and pi float16, values float32); the train
step gathers its minibatch rows there, so the host ships only an index
vector per step instead of the minibatch (the reference ships every
minibatch through a DataLoader, Coach.py:466-469).

Semantics, as in the JAX package: the logical window is every stored row of
iterations [first, last] still resident in the ring. When an upload wraps,
the oldest resident rows are evicted (their segments shrink). The batch
distribution is the host feed's (shuffled epochs without replacement,
drop-last): the host draws the permutation over the resident physical rows
with the same numpy Generator and ships the indices.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: Rows per ring write; uploads are padded to a multiple of it.
_CHUNK = 8192


class DeviceWindow:
    """Fixed-capacity ring of training samples resident on ``device``."""

    def __init__(self, obs_shape: Tuple[int, ...], action_size: int,
                 value_size: int, rows: int, chunk: int = _CHUNK,
                 device="cuda"):
        self.chunk = int(chunk)
        # Capacity rounds up to a chunk multiple so that padded uploads
        # always fit.
        self.rows = -(-int(rows) // self.chunk) * self.chunk
        self.device = torch.device(device)
        self.obs = torch.zeros((self.rows,) + tuple(obs_shape),
                               dtype=torch.float16, device=self.device)
        self.pi = torch.zeros((self.rows, int(action_size)),
                              dtype=torch.float16, device=self.device)
        self.val = torch.zeros((self.rows, int(value_size)),
                               dtype=torch.float32, device=self.device)
        self.cursor = 0
        #: iteration -> list of [start, end) physical ranges (host metadata).
        self.segments: Dict[int, List[Tuple[int, int]]] = {}

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in (self.obs, self.pi, self.val))

    @property
    def buffers(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (self.obs, self.pi, self.val)

    def _evict(self, start: int, end: int) -> None:
        """Remove physical range [start, end) from every segment."""
        for it in list(self.segments):
            kept: List[Tuple[int, int]] = []
            for s, e in self.segments[it]:
                if e <= start or s >= end:
                    kept.append((s, e))
                    continue
                if s < start:
                    kept.append((s, start))
                if e > end:
                    kept.append((end, e))
            if kept:
                self.segments[it] = kept
            else:
                del self.segments[it]

    def has_iteration(self, iteration: int) -> bool:
        return iteration in self.segments

    def drop_before(self, first_iter: int) -> None:
        """Forget iterations outside the window."""
        for it in list(self.segments):
            if it < first_iter:
                del self.segments[it]

    def add_iteration(self, iteration: int, obs: np.ndarray, pi: np.ndarray,
                      val: np.ndarray) -> int:
        """Upload one iteration's rows (an input larger than the ring is
        subsampled to its capacity first, by a fixed stride). Returns the
        rows stored."""
        n = len(obs)
        if n == 0:
            self.segments.setdefault(iteration, [])
            return 0
        if n > self.rows:
            print(f"[device-window] iteration {iteration}: keeping "
                  f"{self.rows} of {n} rows (ring capacity)")
            keep = np.linspace(0, n - 1, self.rows).astype(np.int64)
            obs, pi, val = obs[keep], pi[keep], val[keep]
            n = self.rows
        n_pad = -(-n // self.chunk) * self.chunk
        if self.cursor + n_pad > self.rows:
            # Wrap: the tail [cursor, rows) is retired, writes restart at 0.
            self._evict(self.cursor, self.rows)
            self.cursor = 0
        start = self.cursor
        self._evict(start, start + n_pad)
        for buf, rows, dtype in ((self.obs, obs, np.float16),
                                 (self.pi, pi, np.float16),
                                 (self.val, val, np.float32)):
            buf[start:start + n] = torch.from_numpy(
                np.ascontiguousarray(rows, dtype)).to(self.device)
            buf[start + n:start + n_pad] = 0
        self.segments.setdefault(iteration, []).append((start, start + n))
        self.cursor = start + n_pad
        return n

    def sync(self, store, first_iter: int, last_iter: int) -> None:
        """Make iterations [first_iter, last_iter] resident: upload those the
        ring does not hold (from their sample files, which is also the path
        after a restart) and forget those that left the window."""
        self.drop_before(first_iter)
        for it in range(first_iter, last_iter + 1):
            if self.has_iteration(it):
                continue
            data = store.load(it)
            if data is None:
                continue
            self.add_iteration(it, *data)

    def indices_for(self, first_iter: int, last_iter: int) -> np.ndarray:
        """Physical rows of every resident sample of the window, in
        (iteration, position) order: the host's sampling population."""
        ranges = [np.arange(s, e, dtype=np.int32)
                  for it in range(first_iter, last_iter + 1)
                  for s, e in self.segments.get(it, []) if e > s]
        if not ranges:
            return np.zeros((0,), np.int32)
        return np.concatenate(ranges)
