"""Dataset and loader for temporal graph sequences.

Counterpart of ``tagan_tpu.data.dataset``:

* ``TemporalGraphDataset``: ragged sequences and their labels;
  ``__getitem__`` -> (sequence, label), ``get_statistics``, ``split``,
  ``subset`` and ``kfold``.
* ``TemporalGraphDataLoader``: batches sequences into static-shape padded
  `SnapshotSequence` stacks of CPU tensors (the model moves them to its
  device) and yields ``(batch, labels, sample_mask)``. The final partial
  batch is padded to full size by repeating its last sequence, and
  ``sample_mask`` marks the real ones.

For the same seed the loader gives the JAX package's batches in the same
order: the same numpy permutations, the same buckets, the same padding.
The spatial-backend plans (``plan="hybrid"``/``"ring"``) and the slot
reordering (``reorder="rcm"``) belong to backends that are not ported
and raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import (SnapshotSequence, batch_sequences, build_sequence,
                          pad_dims_for)


class TemporalGraphDataset:
    """Sequences and labels. ``data`` is a list of sequences (then
    ``labels`` gives their labels, or every label is a dummy 0.0 for
    inference) or a list of (sequence, label) pairs."""

    def __init__(self, data: Sequence, labels: Optional[Sequence] = None):
        if labels is None:
            items = list(data)
            if items and isinstance(items[0], (tuple, list)) \
                    and len(items[0]) == 2 \
                    and not isinstance(items[0][1], (tuple, list)):
                # [(sequence, label)] pairs; a raw 2-snapshot sequence
                # would have a snapshot in slot 1, not a scalar
                self.sequences = [s for s, _ in items]
                self.labels = [l for _, l in items]
            else:
                # unlabeled sequences: dummy labels, never read by predict
                self.sequences = items
                self.labels = [0.0] * len(items)
        else:
            self.sequences = list(data)
            self.labels = list(labels)
        if len(self.sequences) != len(self.labels):
            raise ValueError(f"{len(self.sequences)} sequences but "
                             f"{len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.sequences)

    def __getitem__(self, idx: int):
        return self.sequences[idx], self.labels[idx]

    def get_statistics(self) -> dict:
        Tm, Nm, Em, Fe = pad_dims_for(self.sequences)
        num_steps = [len(s) for s in self.sequences]
        labels = np.asarray(self.labels, dtype=np.float64)
        return {
            "num_sequences": len(self.sequences),
            "max_time_steps": Tm,
            "mean_time_steps": float(np.mean(num_steps)) if num_steps else 0,
            "max_nodes": Nm,
            "max_edges": Em,
            "edge_feature_dim": Fe,
            "label_mean": float(labels.mean()) if len(labels) else 0.0,
            "label_counts": {float(v): int(c) for v, c in
                             zip(*np.unique(labels, return_counts=True))},
        }

    def split(self, fractions=(0.7, 0.15, 0.15), seed: int = 42):
        """(train, val, test) datasets from one seeded permutation."""
        n = len(self)
        idx = np.random.default_rng(seed).permutation(n)
        n_train = int(fractions[0] * n)
        n_val = int(fractions[1] * n)
        parts = (idx[:n_train], idx[n_train:n_train + n_val],
                 idx[n_train + n_val:])
        return tuple(self.subset(part) for part in parts)

    def subset(self, indices) -> "TemporalGraphDataset":
        return TemporalGraphDataset([self.sequences[i] for i in indices],
                                    [self.labels[i] for i in indices])

    def kfold(self, num_folds: int = 5, seed: int = 42):
        """Yield (train_dataset, val_dataset) for each of ``num_folds``
        folds of one seeded permutation."""
        n = len(self)
        if num_folds < 2 or num_folds > n:
            raise ValueError(f"num_folds must be in [2, {n}], "
                             f"got {num_folds}")
        idx = np.random.default_rng(seed).permutation(n)
        folds = np.array_split(idx, num_folds)
        for f in range(num_folds):
            train_idx = np.concatenate(
                [folds[j] for j in range(num_folds) if j != f])
            yield self.subset(train_idx), self.subset(folds[f])


class TemporalGraphDataLoader:
    """Static-shape batching loader; yields (SnapshotSequence stacked
    batch, labels, sample_mask).

    ``num_buckets > 1`` groups sequences into size buckets by node count,
    each padded to its own dims; batches never mix buckets.
    ``num_workers > 0`` packs upcoming batches on a thread pool with
    ``prefetch`` batches in flight; order and contents are those of the
    synchronous path. ``dense_adj=False`` skips the [T, N, N] adjacency
    (the flash backend builds its masks from the edge lists)."""

    def __init__(self, dataset: TemporalGraphDataset, batch_size: int = 16,
                 shuffle: bool = False, seed: int = 0,
                 max_time: Optional[int] = None,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 edge_feature_dim: Optional[int] = None,
                 drop_remainder: bool = False,
                 num_buckets: int = 1,
                 num_workers: int = 0,
                 prefetch: int = 2,
                 reorder: Optional[str] = None,
                 dense_adj: bool = True,
                 plan: Optional[str] = None,
                 plan_kwargs: Optional[dict] = None):
        if reorder is not None:
            raise NotImplementedError(
                f"reorder={reorder!r}: the slot reordering is not ported")
        if plan is not None:
            raise NotImplementedError(
                f"plan={plan!r}: the hybrid and ring backends are not ported")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        Tm, Nm, Em, Fe = pad_dims_for(dataset.sequences) \
            if len(dataset) else (1, 1, 1, 0)
        self.max_time = max_time or Tm
        self.max_nodes = max_nodes or Nm
        self.max_edges = max_edges or max(Em, 1)
        self.edge_feature_dim = Fe if edge_feature_dim is None \
            else edge_feature_dim
        self._epoch = 0
        self._cache: List[Optional[SnapshotSequence]] = [None] * len(dataset)
        self.num_buckets = max(1, num_buckets)
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.dense_adj = dense_adj
        self._bucket_of, self._bucket_dims = self._assign_buckets()

    def _seq_node_count(self, i: int) -> int:
        ids = set()
        for s in self.dataset.sequences[i]:
            ids.update(s["node_ids"] if isinstance(s, dict) else s[3])
        return len(ids)

    def _assign_buckets(self):
        n = len(self.dataset)
        if self.num_buckets <= 1 or n == 0:
            return ([0] * n,
                    {0: (self.max_time, self.max_nodes, self.max_edges)})
        counts = np.asarray([self._seq_node_count(i) for i in range(n)])
        order = np.argsort(counts)
        bucket_of = [0] * n
        dims = {}
        per = (n + self.num_buckets - 1) // self.num_buckets
        for b in range(self.num_buckets):
            members = order[b * per:(b + 1) * per]
            if len(members) == 0:
                continue
            sub = [self.dataset.sequences[int(i)] for i in members]
            Tm, Nm, Em, _ = pad_dims_for(sub)
            dims[b] = (min(Tm, self.max_time) if self.max_time else Tm,
                       Nm, max(Em, 1))
            for i in members:
                bucket_of[int(i)] = b
        return bucket_of, dims

    def _built(self, i: int) -> SnapshotSequence:
        if self._cache[i] is None:
            Tm, Nm, Em = self._bucket_dims[self._bucket_of[i]]
            self._cache[i] = build_sequence(
                self.dataset.sequences[i], max_nodes=Nm, max_edges=Em,
                max_time=Tm, edge_feature_dim=self.edge_feature_dim,
                dense_adj=self.dense_adj)
        return self._cache[i]

    def __len__(self) -> int:
        total = 0
        for b in self._bucket_dims:
            n = sum(1 for x in self._bucket_of if x == b)
            if self.drop_remainder:
                total += n // self.batch_size
            else:
                total += (n + self.batch_size - 1) // self.batch_size
        return total

    def __iter__(self) -> Iterator[Tuple[SnapshotSequence, torch.Tensor,
                                         torch.Tensor]]:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        bs = self.batch_size
        labels_np = np.asarray(self.dataset.labels)
        label_dtype = torch.int32 if np.issubdtype(labels_np.dtype,
                                                   np.integer) \
            else torch.float32

        batches = []
        for b in self._bucket_dims:
            members = np.asarray([i for i in range(n)
                                  if self._bucket_of[i] == b])
            if self.shuffle:
                members = rng.permutation(members)
            for start in range(0, len(members), bs):
                idx = members[start:start + bs]
                if len(idx) < bs:
                    if self.drop_remainder:
                        continue
                    idx_full = np.concatenate(
                        [idx, np.repeat(idx[-1:], bs - len(idx))])
                    mask = np.zeros(bs, bool)
                    mask[: len(idx)] = True
                else:
                    idx_full = idx
                    mask = np.ones(bs, bool)
                batches.append((idx_full, mask))
        if self.shuffle:
            rng.shuffle(batches)

        def make(idx_full, mask):
            batch = batch_sequences([self._built(int(i)) for i in idx_full])
            labels = torch.as_tensor(labels_np[idx_full], dtype=label_dtype)
            return batch, labels, torch.from_numpy(mask)

        if self.num_workers <= 0:
            for idx_full, mask in batches:
                yield make(idx_full, mask)
            return

        # up to `prefetch` batches in flight, yielded in order
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(self.num_workers) as ex:
            pending = deque()
            it = iter(batches)
            for nb in (next(it, None) for _ in range(self.prefetch)):
                if nb is None:
                    break
                pending.append(ex.submit(make, *nb))
            while pending:
                fut = pending.popleft()
                nb = next(it, None)
                if nb is not None:
                    pending.append(ex.submit(make, *nb))
                yield fut.result()
