"""Row partitions onto HELL layouts (plain torch products on each shard).

Counterpart of :mod:`spgpu_tpu.parallel.partition`: the same row split
and halo plan as the packed and classic partitions
(:func:`~spgpu_tpu_torch.parallel.partition_packed.halo_plan`; the JAX
module's own plan is the same), and two HELL layouts per shard in the
original numbering: the interior one over ``(chunk, chunk)``, columns
local, and the exterior one over ``(chunk, S*K)``, columns the flat halo
buffer's positions (owner ``p``'s ``k``-th value at ``p*K + k``).  Each
slab is the JAX partition's slab of that shard, array for array: every
hack has at least one tile of slots, even an empty one.  Where the JAX
package pads every shard's slabs to one slot count and stacks them
(``shard_map`` needs one shape), each rank of the port holds its own
layouts, and a shard with no halo entry has no exterior layout.  Values
are float32, float64, complex64 or complex128, each native.  The JAX
``make_row_mesh`` has no counterpart: the group is ``torch.distributed``'s
(:mod:`.group`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgpu_tpu_torch.core import DEFAULT_HACK_SIZE, round_up, sublanes, value_dtype
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.hell import HellMatrix
from spgpu_tpu_torch.parallel.partition_whell import RowPartition, build_row_shards

__all__ = ["PartitionedMatrix", "hell_from_entries", "pad_vector", "partition_coo_rows"]


def hell_from_entries(rows, cols, vals, n_rows: int, n_cols: int, *,
                      avg_nnz_per_row: float, hack_size: int = DEFAULT_HACK_SIZE
                      ) -> HellMatrix:
    """One shard's slab as the JAX partition builds it
    (``_hell_arrays_from_entries``): entries of local rows ``rows`` over
    ``n_rows`` (whole hacks), each hack at least one tile of slots wide,
    duplicates kept as separate slots.  On the CPU."""
    sub = sublanes(vals.dtype)
    counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
    num_hacks = max(n_rows // hack_size, 1)
    w = counts.reshape(num_hacks, hack_size).max(axis=1)
    w = np.maximum(round_up(1, sub), -(-w // sub) * sub)
    ho = np.zeros(num_hacks + 1, dtype=np.int64)
    np.cumsum(w, out=ho[1:])
    total = int(ho[-1])
    v = np.zeros((total, hack_size), dtype=vals.dtype)
    c = np.zeros((total, hack_size), dtype=np.int32)
    if rows.size:
        order = np.argsort(rows, kind="stable")
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        k = np.arange(rows.size, dtype=np.int64) - starts[rows[order]]
        r = rows[order]
        v[ho[r // hack_size] + k, r % hack_size] = vals[order]
        c[ho[r // hack_size] + k, r % hack_size] = cols[order]
    return HellMatrix(
        values=torch.from_numpy(v), col_indices=torch.from_numpy(c),
        hack_offsets=torch.from_numpy(ho.astype(np.int32)),
        slot_to_hack=torch.from_numpy(np.repeat(np.arange(num_hacks, dtype=np.int32), w)),
        row_lengths=None, row_perm=None, n_rows=n_rows, n_cols=n_cols,
        hack_size=hack_size, total_slots=total, max_hack_width=int(w.max()),
        avg_nnz_per_row=avg_nnz_per_row)


@dataclasses.dataclass
class PartitionedMatrix(RowPartition):
    """A row-partitioned square matrix on HELL layouts, one
    :class:`~spgpu_tpu_torch.parallel.partition_whell.RowShard` per shard
    (on the CPU); vectors are the values' type."""

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].interior.values.dtype


def partition_coo_rows(coo: CooMatrix, n_shards: int) -> PartitionedMatrix:
    """Build a :class:`PartitionedMatrix` of a square host COO (float32,
    float64, complex64 or complex128 values) on the CPU.  Duplicate
    coordinates stay separate slots, as in the single-device conversions
    (``ell.c:65-78``)."""
    dt = value_dtype(coo.values.dtype, "the HELL partition")
    chunk = round_up(-(-coo.n_rows // n_shards), DEFAULT_HACK_SIZE)
    avg = coo.nnz / max(n_shards * chunk, 1)

    def convert(rows, cols, vals, n_rows, n_cols):
        return hell_from_entries(rows, cols, vals.astype(dt), n_rows, n_cols,
                                 avg_nnz_per_row=avg)

    shards, chunk, K, halo_counts = build_row_shards(coo, n_shards, convert)
    return PartitionedMatrix(shards=shards, n_rows=coo.n_rows, chunk=chunk,
                             halo_width=K, nnz=coo.nnz, halo_counts=halo_counts)


def pad_vector(x, padded_rows: int) -> torch.Tensor:
    """Zero-pad a global vector (or a stack of them, along the last axis)
    to ``padded_rows``, a partition's padded length."""
    x = torch.as_tensor(x)
    pad = padded_rows - x.shape[-1]
    if pad < 0:
        raise ValueError(f"a vector of {x.shape[-1]} rows does not fit {padded_rows}")
    return torch.nn.functional.pad(x, (0, pad)) if pad else x
