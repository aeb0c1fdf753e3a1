"""Batch samplers: length-grouped and task-grouped index orderings.

Numpy ports of the reference samplers (llava_trainer.py:84-269). The
flagship recipe uses ``group_by_task_length`` (train_multi.sh): per-task
length-grouped megabatches, last partial megabatch of each task dropped,
megabatches shuffled.

The port's own copy of ``video3d_tpu/train/samplers.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy balanced split (llava_trainer.py:84-103)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lengths.index(min(chunk_lengths))
        chunks[shortest].append(index)
        chunk_lengths[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None) -> List[int]:
    """Random megabatches, length-sorted within, balanced across ranks
    (llava_trainer.py:176-196)."""
    rng = rng or np.random.default_rng()
    indices = rng.permutation(len(lengths))
    mb = world_size * batch_size
    megabatches = [list(indices[i:i + mb]) for i in range(0, len(lengths), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size) for m in megabatches]
    return [i for m in megabatches for batch in m for i in batch]


def get_task_length_grouped_indices(lengths: Sequence[Tuple[int, int]],
                                    batch_size: int, world_size: int,
                                    rng: Optional[np.random.Generator] = None) -> List[int]:
    """Per-task length-grouped megabatches, last partial megabatch of each
    task dropped, megabatches shuffled (llava_trainer.py:243-269)."""
    rng = rng or np.random.default_rng()
    assert all(l != 0 for _, l in lengths), "Should not have zero length."
    task_indices, task_lengths = defaultdict(list), defaultdict(list)
    for i, (task_id, l) in enumerate(lengths):
        task_indices[task_id].append(i)
        task_lengths[task_id].append(l)

    mb = world_size * batch_size
    megabatches: List[List[int]] = []
    for task_id in task_indices:
        order = get_length_grouped_indices(task_lengths[task_id], batch_size,
                                           world_size, rng)
        shuffled = [task_indices[task_id][i] for i in order]
        task_mbs = [shuffled[i:i + mb] for i in range(0, len(shuffled), mb)]
        megabatches.extend(task_mbs[:-1])     # drop last partial per task

    perm = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in perm]
    return [i for m in megabatches for i in m]


def get_modality_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                                        world_size: int,
                                        rng: Optional[np.random.Generator] = None) -> List[int]:
    """Group by modality id (1=ground, 2=qa, 3=cap), length-grouped within
    (llava_trainer.py:122-173)."""
    rng = rng or np.random.default_rng()
    groups = defaultdict(list)
    for i, l in enumerate(lengths):
        groups[l].append(i)

    mb = world_size * batch_size
    megabatches: List[List[int]] = []
    for mod, idxs in groups.items():
        sub_lengths = [1] * len(idxs)   # lengths within modality are the ids
        order = get_length_grouped_indices(sub_lengths, batch_size, world_size, rng)
        shuffled = [idxs[i] for i in order]
        mbs = [shuffled[i:i + mb] for i in range(0, len(shuffled), mb)]
        megabatches.extend(mbs[:-1])
    perm = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in perm]
    return [i for m in megabatches for i in m]


def batches_from_order(order: Sequence[int], batch_size: int) -> List[List[int]]:
    """Chunk a flat index order into per-step batches (drop last partial)."""
    out = [list(order[i:i + batch_size]) for i in range(0, len(order), batch_size)]
    if out and len(out[-1]) < batch_size:
        out.pop()
    return out
