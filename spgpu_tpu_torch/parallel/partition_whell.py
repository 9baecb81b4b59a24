"""Row partitions onto classic WHELL layouts (kernel #15 on each shard).

Counterpart of :mod:`spgpu_tpu.parallel.partition_whell`: the same row
split and halo plan as the packed partition
(:func:`~spgpu_tpu_torch.parallel.partition_packed.halo_plan`, the rows
and layouts built by :func:`build_row_shards`, which the HELL partition
shares), and two
classic layouts per shard (float32 or float64, the COO's type) in the
original numbering: the interior
one over the shard's own ``(chunk, chunk)`` block, whose product reads the
local x, and the exterior one over ``(chunk, S*K)``, whose columns index
the flat received halo buffer (owner ``p``'s ``k``-th value at ``p*K +
k``).  Where the JAX package pads every shard's slabs to one tile count
and stacks them, each rank of the port holds its own layouts; a shard
with no halo entry has no exterior layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from spgpu_tpu_torch.convert.whell import coo_to_whell
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.whell import WhellMatrix
from spgpu_tpu_torch.parallel.partition_packed import halo_plan

__all__ = ["PartitionedWhell", "RowPartition", "RowShard", "build_row_shards",
           "partition_coo_rows_whell"]


@dataclasses.dataclass
class RowShard:
    """One shard's part of a partition onto original-numbering layouts
    (:class:`PartitionedWhell`, the HELL ``PartitionedMatrix``)."""

    interior: object  # (chunk, chunk): classic WhellMatrix or HellMatrix
    exterior: Optional[object]  # (chunk, S*K); None without halo
    #: requester -> this shard's local rows it sends there (int64)
    send_lanes: Dict[int, torch.Tensor]
    #: owner -> the halo buffer positions its values land in (int64)
    halo_lanes: Dict[int, torch.Tensor]
    n_local: int

    def to(self, device) -> "RowShard":
        return RowShard(
            interior=self.interior.to(device),
            exterior=None if self.exterior is None else self.exterior.to(device),
            send_lanes={r: t.to(device) for r, t in self.send_lanes.items()},
            halo_lanes={p: t.to(device) for p, t in self.halo_lanes.items()},
            n_local=self.n_local)


@dataclasses.dataclass
class RowPartition:
    """A row-partitioned square matrix on original-numbering layouts, one
    :class:`RowShard` per shard (on the CPU): the part the classic WHELL
    and HELL partitions share.  Vectors are the shards' ``dtype``."""

    shards: List[RowShard]
    n_rows: int
    chunk: int
    halo_width: int
    nnz: int
    halo_counts: tuple

    #: the interior product always runs while the halo is in flight
    overlapped = True

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def no_halo(self) -> bool:
        return not any(c for row in self.halo_counts for c in row)

    @property
    def halo_size(self) -> int:
        """The flat halo buffer's length, ``S*K``."""
        return self.n_shards * self.halo_width

    def rows_of(self, s: int) -> slice:
        return slice(s * self.chunk, s * self.chunk + self.shards[s].n_local)

    def shard(self, s: int, device) -> RowShard:
        return self.shards[s].to(device)

    def embed_shard(self, x, s: int, device=None, fill=0) -> torch.Tensor:
        """Global ``(n,)`` vector -> shard ``s``'s ``(chunk,)`` block (rows
        past the matrix ``fill``), in the partition's ``dtype``, on
        ``device``."""
        out = torch.full((self.chunk,), fill, dtype=self.dtype)
        out[: self.shards[s].n_local] = torch.as_tensor(
            np.asarray(x)[self.rows_of(s)]).to(self.dtype)
        return out.to(device or "cpu")

    def extract_shard(self, z: torch.Tensor, s: int) -> torch.Tensor:
        return z[: self.shards[s].n_local]


@dataclasses.dataclass
class PartitionedWhell(RowPartition):
    """A row-partitioned square float32 or float64 matrix on classic WHELL
    layouts."""

    @property
    def dtype(self) -> torch.dtype:
        """The vectors' type: the shards' values' (float32 or float64)."""
        return self.shards[0].interior.values.dtype


def build_row_shards(coo: CooMatrix, n_shards: int, convert):
    """The row split and halo plan of :func:`halo_plan` with each shard's
    interior and exterior entries converted by ``convert(rows, cols,
    values, n_rows, n_cols)`` (exterior columns are halo positions ``p*K +
    k``; a shard with no exterior entry has no exterior layout).  Returns
    ``(shards, chunk, K, halo_counts)``."""
    chunk, per_shard, send, halo_pos, K, halo_counts = halo_plan(coo, n_shards)
    S = n_shards
    shards = []
    for s, (lrows, cols_g, vals) in enumerate(per_shard):
        is_int = cols_g // chunk == s
        interior = convert(lrows[is_int], cols_g[is_int] - s * chunk, vals[is_int],
                           chunk, chunk)
        exterior = None
        if not is_int.all():
            exterior = convert(lrows[~is_int], halo_pos[s], vals[~is_int], chunk, S * K)
        shards.append(RowShard(
            interior=interior, exterior=exterior,
            send_lanes={r: torch.from_numpy(send[s][r]) for r in range(S)
                        if halo_counts[s][r]},
            halo_lanes={p: p * K + torch.arange(halo_counts[p][s]) for p in range(S)
                        if halo_counts[p][s]},
            n_local=max(0, min(chunk, coo.n_rows - s * chunk))))
    return shards, chunk, K, halo_counts


def partition_coo_rows_whell(coo: CooMatrix, n_shards: int) -> PartitionedWhell:
    """Build a :class:`PartitionedWhell` of a square host COO (float32 or
    float64 values, each shard's layouts converted in that type), on the
    CPU."""
    def convert(rows, cols, vals, n_rows, n_cols):
        return coo_to_whell(CooMatrix(rows, cols, vals, n_rows, n_cols), device="cpu",
                            packed=False)

    shards, chunk, K, halo_counts = build_row_shards(coo, n_shards, convert)
    return PartitionedWhell(shards=shards, n_rows=coo.n_rows, chunk=chunk,
                            halo_width=K, nnz=coo.nnz, halo_counts=halo_counts)
