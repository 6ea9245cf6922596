"""Host data pipeline with prefetch and a checkpointable cursor.

Counterpart of ``repro.data.pipeline``.  ``ShardedLoader`` wraps the
synthetic token stream (``data.synthetic.token_batch``), carves the
global batch into per-host shards, builds batches ahead on a background
thread, and exposes ``state_dict`` / ``load_state_dict`` so the cursor
rides along with checkpoints (exact resume: no batch replayed or
skipped).  ``to_device`` moves a host batch to the device from pinned
memory without blocking the host; under a train mesh ``shard_batch``
first takes the data rank's rows, as the JAX package's
``device_put_sharded_batch`` lays a batch over the mesh.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic as syn


def make_batch(cfg: ArchConfig, state: syn.TokenStreamState, batch: int,
               seq: int) -> tuple[dict, syn.TokenStreamState]:
    """One host batch of ``seq`` tokens and the shifted labels, plus the
    family's modality input (encdec frames, vlm prefix embeds: N(0, 1) ·
    0.02 from a generator seeded by the cursor's step, as the reference
    loader draws them), and the advanced cursor."""
    toks, new_state = syn.token_batch(state, batch, seq + 1, cfg.vocab_size)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        from repro_torch.models.encdec import ENC_LEN
        rng = np.random.default_rng(state.step)
        out["frames"] = rng.standard_normal(
            (batch, ENC_LEN, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        rng = np.random.default_rng(state.step)
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model)).astype(
                np.float32) * 0.02
    return out, new_state


class ShardedLoader:
    """Prefetching, host-sharded, exactly-resumable loader (one host of
    ``num_hosts``; the port trains on one)."""

    def __init__(self, cfg: ArchConfig, global_batch: int, seq: int,
                 seed: int = 0, host: int = 0, num_hosts: int = 1,
                 prefetch: int = 2):
        self.cfg = cfg
        self.host = host
        self.num_hosts = num_hosts
        if global_batch % self.num_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.num_hosts} hosts")
        self.local_batch = global_batch // self.num_hosts
        self.seq = seq
        self.prefetch = prefetch
        self.state = syn.TokenStreamState(seed=seed, host=self.host,
                                          num_hosts=self.num_hosts)
        self._start()

    # -- background producer ------------------------------------------------
    def _start(self):
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        args=(self.state, self._q,
                                              self._stop), daemon=True)
        self._thread.start()

    def _worker(self, state, q, stop):
        while not stop.is_set():
            batch, state = make_batch(self.cfg, state, self.local_batch,
                                      self.seq)
            while not stop.is_set():
                try:
                    q.put((batch, state), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> dict:
        batch, self.state = self._q.get()
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)

    # -- checkpointable cursor ----------------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.state.seed, "host": self.state.host,
                "num_hosts": self.state.num_hosts, "step": self.state.step}

    def load_state_dict(self, d: dict):
        """Continue from cursor ``d``: batches prefetched from the stale
        cursor are dropped with their queue."""
        self.close()
        self.state = syn.TokenStreamState(**d)
        self._start()


def shard_batch(batch: dict, mesh, micro_batches: int = 1) -> dict:
    """Data rank ``mesh.data.index``'s rows of a global host batch (every
    leaf split on its leading axis), for a train step of
    ``micro_batches``: micro-batch i is global rows [i·B/mb, (i+1)·B/mb)
    split evenly over the data ranks, and the rank's shares of the
    micro-batches follow one another.  With one micro-batch that is the
    rank's contiguous block of B / D rows (``device_put_sharded_batch``'s
    layout); the model ranks of a data rank take the same rows."""
    d, i = mesh.data.size, mesh.data.index
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % (d * micro_batches):
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{micro_batches} micro-batches over {d} data "
                             "ranks")
        n = B // (d * micro_batches)
        rows = [v[j * d * n + i * n:j * d * n + (i + 1) * n]
                for j in range(micro_batches)]
        out[k] = np.concatenate(rows) if isinstance(v, np.ndarray) \
            else torch.cat(rows)
    return out


def to_device(batch: dict, device) -> dict:
    """A host numpy batch as tensors on ``device``: on CUDA copied from
    pinned memory without blocking the host (integer leaves as int64,
    the rest as they are)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
