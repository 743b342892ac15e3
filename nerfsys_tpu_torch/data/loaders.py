"""Batched episode assembly and background prefetch for the outer step.

The port's own copy of nerfsys_tpu/data/loaders.py (`MetaBatcher` :28,
`PrefetchLoader` :161, `EpochBatchSampler` :224). MetaBatcher assembles the fixed-shape stacked batch
that `make_train_step` consumes:

  { support_rays (K,B,S,8), support_rgbs (K,B,S,3),
    query_rays (K,B,Q,8),  query_rgbs (K,B,Q,3),  valid (K,B) }

Regions that fail to produce a task are zero-filled and masked out through
`valid`; their rays are far(0) < near(1). A daemon thread keeps `prefetch`
batches ready, so host sampling overlaps the step.

Batches reach the step as tensors on its device: given a CUDA `device`,
the prefetch thread copies each batch from pinned host memory on a stream
of its own and records an event, and `__next__` makes the consumer's
current stream wait on that event, so neither the copy nor the host stalls
the step. On the CPU the numpy arrays become tensors without a copy.

EpochBatchSampler feeds test-time adaptation: one shuffled pass over a
RamRaysDataset in numpy batches, which the adapt step uploads itself.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List

import numpy as np
import torch

from nerfsys_tpu_torch.data.task_dataset import TaskDataset


class MetaBatcher:
    """Assemble (K regions x B tasks) fixed-shape episode batches."""

    def __init__(self, task_datasets: List[TaskDataset], batch_size: int):
        assert task_datasets, "need at least one region TaskDataset"
        self.tds = task_datasets
        self.B = int(batch_size)
        self.K = len(task_datasets)
        self.S = task_datasets[0].S
        self.Q = task_datasets[0].Q

    def next_index_plan(self) -> Dict[str, np.ndarray]:
        """One batch as ray-index arrays, before the ray data is gathered:
        {sup_idx (K,B,S) int64, qry_idx (K,B,Q) int64, valid (K,B)}."""
        K, B, S, Q = self.K, self.B, self.S, self.Q
        plan = {
            "sup_idx": np.zeros((K, B, S), np.int64),
            "qry_idx": np.zeros((K, B, Q), np.int64),
            "valid": np.zeros((K, B), np.float32),
        }
        for k, td in enumerate(self.tds):
            for b in range(self.B):
                t = td.sample_task()
                if t is None:
                    continue
                plan["sup_idx"][k, b] = t.support["idx"]
                plan["qry_idx"][k, b] = t.query["idx"]
                plan["valid"][k, b] = 1.0
        return plan

    def materialize(self, plan: Dict[str, np.ndarray],
                    name: str) -> np.ndarray:
        """Gather one array of an index plan's batch."""
        if name == "valid":
            return plan["valid"]
        split, leaf = name.split("_")  # support|query _ rays|rgbs
        idx_all = plan["sup_idx"] if split == "support" else plan["qry_idx"]
        K, B, n_s = idx_all.shape
        out = np.zeros((K, B, n_s, 8 if leaf == "rays" else 3), np.float32)
        if leaf == "rays":
            out[..., 6] = 1.0  # padded/invalid tasks: far(0) < near(1)
        for k in range(K):
            ds = self.tds[k].ds
            src = ds.rays if leaf == "rays" else ds.rgbs
            for b in range(B):
                if plan["valid"][k, b]:
                    out[k, b] = src[idx_all[k, b]]
        return out

    def batch_from_plan(self, plan: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        return {name: self.materialize(plan, name)
                for name in ("support_rays", "support_rgbs", "query_rays",
                             "query_rgbs", "valid")}

    def next_batch(self) -> Dict[str, np.ndarray]:
        return self.batch_from_plan(self.next_index_plan())

    def __iter__(self):
        while True:
            yield self.next_batch()


class EpochBatchSampler:
    """Shuffled single pass over a RamRaysDataset in fixed-size numpy
    batches; the final short batch is padded by wrap-around, so every
    batch has the same shape. The permutation is numpy's
    `default_rng(seed)`, as the reference draws it."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        n = len(self.ds)
        order = self.rng.permutation(n)
        for s in range(0, n, self.batch_size):
            idx = order[s:s + self.batch_size]
            if idx.size < self.batch_size:
                idx = np.concatenate([idx, order[:self.batch_size - idx.size]])
            yield {"rays": self.ds.rays[idx], "rgbs": self.ds.rgbs[idx],
                   "img_indices": self.ds.img_indices[idx]}


class PrefetchLoader:
    """Wrap an infinite iterator of numpy batches with a daemon prefetch
    thread; batches come out as tensors on `device` (module docstring)."""

    def __init__(self, source, device, prefetch: int = 2):
        self._source = iter(source)
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _upload(self, batch):
        """-> (batch, event or None)."""
        if self._stream is None:
            return {k: torch.from_numpy(np.asarray(v)).to(self._device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(
                self._device, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _work(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                self._q.put(self._upload(item))
        except Exception as e:  # surface worker errors to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():  # allocated on the copy stream
                t.record_stream(stream)
        return batch

    def close(self):
        """Stop the thread and wait for it: it ends after the item in hand
        (an upload in flight must not outlive the interpreter)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
