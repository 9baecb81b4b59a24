"""BCOO and BHDIA block layouts as dataclasses of torch tensors.

Counterparts of :class:`spgpu_tpu.formats.bcoo.BcooMatrix` and
``BhdiaMatrix``; the arrays are the same, cell for cell.  spGPU ships
these conversions (``coo.cpp:7-96``, ``hdia.cpp:351-373``) but no block
SpMV; the JAX package adds one over BCOO (``ops.bcoo_spmv``) and so does
the port.  Blocks are row-major ``(n_blocks, block_rows, block_cols)``,
ordered by (block row, block column).  A BHDIA slot holds one block
diagonal of one hack of block rows: ``values`` is ``(total_slots,
hack_size, block_rows, block_cols)`` and a padding slot's offset is the
block-column count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgpu_tpu_torch.formats._fields import bridge, host, nbytes, to_device

__all__ = ["BcooMatrix", "BhdiaMatrix", "from_numpy_bcoo", "from_numpy_bhdia"]


@dataclasses.dataclass
class BcooMatrix:
    block_row_idx: torch.Tensor  # (n_blocks,) int32
    block_col_idx: torch.Tensor  # (n_blocks,) int32
    blocks: torch.Tensor  # (n_blocks, block_rows, block_cols)
    n_rows: int
    n_cols: int
    block_rows: int
    block_cols: int

    _TENSORS = ("block_row_idx", "block_col_idx", "blocks")

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_block_rows(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def n_block_cols(self) -> int:
        return -(-self.n_cols // self.block_cols)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def storage_bytes(self) -> int:
        return nbytes(*(getattr(self, n) for n in self._TENSORS))

    def to(self, device) -> "BcooMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper)."""
        blocks = host(self.blocks)
        out = np.zeros((self.n_rows, self.n_cols), dtype=blocks.dtype)
        br, bc = self.block_rows, self.block_cols
        for b, (i, j) in enumerate(zip(host(self.block_row_idx), host(self.block_col_idx))):
            r0, c0 = i * br, j * bc
            r1, c1 = min(r0 + br, self.n_rows), min(c0 + bc, self.n_cols)
            out[r0:r1, c0:c1] += blocks[b, : r1 - r0, : c1 - c0]
        return out


@dataclasses.dataclass
class BhdiaMatrix:
    """HDIA over blocks: each slot one block diagonal of one hack of
    block rows (``bcooToBhdia``, ``hdia.cpp:351-373``)."""

    values: torch.Tensor  # (total_slots, hack_size, block_rows, block_cols)
    offsets: torch.Tensor  # (total_slots,) int32 block col - block row; pad n_block_cols
    hack_offsets: torch.Tensor  # (num_hacks + 1,) int32
    slot_to_hack: torch.Tensor  # (total_slots,) int32
    n_rows: int
    n_cols: int
    block_rows: int
    block_cols: int
    hack_size: int  # block rows a hack

    _TENSORS = ("values", "offsets", "hack_offsets", "slot_to_hack")

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def n_block_rows(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def n_block_cols(self) -> int:
        return -(-self.n_cols // self.block_cols)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def storage_bytes(self) -> int:
        return nbytes(*(getattr(self, n) for n in self._TENSORS))

    def to(self, device) -> "BhdiaMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper)."""
        vals, offs, s2h = host(self.values), host(self.offsets), host(self.slot_to_hack)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        br, bc = self.block_rows, self.block_cols
        for s in np.flatnonzero(offs != self.n_block_cols):
            for lane in range(self.hack_size):
                brow = s2h[s] * self.hack_size + lane
                bcol = brow + offs[s]
                if brow >= self.n_block_rows or not 0 <= bcol < self.n_block_cols:
                    continue
                r0, c0 = brow * br, bcol * bc
                r1, c1 = min(r0 + br, self.n_rows), min(c0 + bc, self.n_cols)
                out[r0:r1, c0:c1] += vals[s, lane, : r1 - r0, : c1 - c0]
        return out


def from_numpy_bcoo(**fields) -> BcooMatrix:
    """The port's :class:`BcooMatrix` from a JAX ``BcooMatrix``'s fields
    by name (arrays as NumPy), on the CPU."""
    return bridge(BcooMatrix, fields)


def from_numpy_bhdia(**fields) -> BhdiaMatrix:
    """The port's :class:`BhdiaMatrix` from a JAX ``BhdiaMatrix``'s fields
    by name (arrays as NumPy), on the CPU."""
    return bridge(BhdiaMatrix, fields)
