"""Row partitions onto packed WHELL layouts: the host plan of the
distributed SpMV.

Counterpart of :mod:`spgpu_tpu.parallel.partition_packed`.  Rows split
into hack-aligned chunks, one per shard (rank).  Each shard's block,
interior columns and halo columns alike, converts as one packed matrix
over an extended square space of ``chunk + S*K`` coordinates: ``0 ..
chunk-1`` are the shard's own rows and columns, ``chunk + p*K + k`` the
``k``-th halo column that owner ``p`` sends (a phantom row with no
entries, whose lane the exterior entries read).  The converter relabels
rows and columns jointly into lane space, so each halo column gets a lane
of its own; per product the received halo values land in those lanes.

With ``overlap=True`` the interior entries (columns the shard owns) and
the exterior ones (halo columns) convert as two slabs that share one lane
map, pinned through ``row_degrees``/``lane_capacity``: the interior
product reads only the shard's own lanes and runs while the halo is in
flight, and the exterior product adds into it after.

Where the JAX package stacks every shard into arrays with a leading shard
axis (``shard_map`` needs one shape), each rank of the port holds its own
layouts:

* no stacking pad.  A shard's interior and exterior slabs share its lane
  map, so they cover the same lane space and the same output groups; the
  port then cuts the exterior after its last output group that holds a
  halo entry (:func:`live_prefix`; a shard without one has no exterior
  product), and the exterior's product adds into the prefix of the
  interior's.  Every output group of a layout has a chunk (the converter
  pads each to whole chunks), so no lane of either product is left
  unwritten;
* the exchange plan holds each (owner, requester) pair's exact lanes and
  only the pairs with a halo: no width buckets, no global-max-K padding,
  no inert phantom targets (the JAX ``ppermute`` rounds need them because
  every shard runs every collective; a rank of the port posts nothing for
  a pair of count 0);
* a complex matrix is one partition with complex slabs (the JAX package
  builds a ``ComplexPackedPartition`` of two real-plane partitions of one
  structure), and a float64 one has float64 slabs (no double-float pairs).
  The structural arrays equal each JAX plane's: with the fp32 default
  geometry for float32 and complex64, and with ``scattered=False`` for
  float64 and complex128 (the port's default there is scattered windows).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from spgpu_tpu_torch.convert.whell import coo_to_whell
from spgpu_tpu_torch.core import round_up
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.whell import (WhellMatrix, from_numpy_fields,
                                           from_numpy_planes)

__all__ = ["PackedPartition", "PackedShard", "build_shard_mats",
           "from_numpy_partition", "halo_plan", "live_prefix",
           "partition_coo_rows_packed"]

_HACK = 128


def _common_geometry(max_nnz: int, max_rows: int, f64: bool):
    """(group_hacks, chunk_tiles) shared by every shard: the JAX
    partition's heuristics applied to the largest shard (``f64``: the
    double-float geometry, float64 and complex128)."""
    est_tiles = max(1, max_nnz // 1024)
    num_hacks = -(-max_rows // _HACK)
    if f64:
        ct = 32 if est_tiles >= 128 else 16
        gh = 128 if num_hacks >= 128 else 32
    else:
        ct = 128 if est_tiles >= 512 else (64 if est_tiles >= 128 else 32)
        gh = 512 if num_hacks >= 512 else (128 if num_hacks >= 128 else 32)
    return gh, ct


def halo_plan(coo: CooMatrix, n_shards: int):
    """The row split and halo plan of the JAX partitions: ``chunk`` (rows
    per shard, whole hacks), each shard's entries ``(local rows, global
    cols, values)``, ``send[p][s]`` (owner ``p``'s local rows that
    requester ``s`` needs, ascending), each shard's halo position of each
    exterior entry (``p*K + k``), ``K`` (the widest pair rounded up to 8)
    and ``halo_counts[p][s]``."""
    if coo.n_rows != coo.n_cols:
        raise ValueError("halo-partitioned SpMV requires a square matrix")
    S = n_shards
    chunk = round_up(-(-coo.n_rows // S), _HACK)
    owner_r = coo.rows // chunk
    per_shard = []
    for s in range(S):
        sel = owner_r == s
        per_shard.append((coo.rows[sel] - s * chunk, coo.cols[sel], coo.values[sel]))
    ext_needed = [np.unique(cols_g[cols_g // chunk != s]) if cols_g.size
                  else np.array([], np.int64)
                  for s, (_, cols_g, _) in enumerate(per_shard)]
    send = [[None] * S for _ in range(S)]
    K = 1
    for s in range(S):
        owners = ext_needed[s] // chunk
        for p in range(S):
            send[p][s] = (ext_needed[s][owners == p] - p * chunk).astype(np.int64)
            K = max(K, send[p][s].size)
    halo_counts = tuple(tuple(send[p][s].size for s in range(S)) for p in range(S))
    K = round_up(K, 8)
    halo_pos = []
    for s in range(S):
        ext, (_, cols_g, _) = ext_needed[s], per_shard[s]
        owners = ext // chunk
        pos = np.empty(ext.size, dtype=np.int64)
        for p in range(S):
            pos[owners == p] = p * K + np.arange(send[p][s].size)
        ec = cols_g[cols_g // chunk != s]
        halo_pos.append(pos[np.searchsorted(ext, ec)] if ec.size else ec)
    return chunk, per_shard, send, halo_pos, K, halo_counts


def build_shard_mats(coo: CooMatrix, n_shards: int, split_exterior: bool = False,
                     scattered: Optional[bool] = None):
    """Split rows into hack-aligned chunks, build the halo plan, and
    convert each shard's block over the extended (``chunk + S*K``) square
    space with one geometry for every shard, on the CPU.  Returns
    ``(mats, send, chunk, K, halo_counts)``: ``mats[s]`` a
    :class:`WhellMatrix`, or with ``split_exterior`` an ``(interior,
    exterior)`` pair sharing one lane map (pinned through ``row_degrees``
    and ``lane_capacity`` computed from the shard's whole entry set;
    raises ``ValueError`` if the two maps diverge), and ``send[p][s]``
    owner ``p``'s local rows that shard ``s`` needs.  ``scattered`` as in
    :func:`~spgpu_tpu_torch.convert.coo_to_whell` (its default: scattered
    windows in every type).  Complex values convert to one complex slab."""
    chunk, per_shard, send, halo_pos, K, halo_counts = halo_plan(coo, n_shards)
    E = chunk + n_shards * K
    f64 = np.dtype(coo.values.dtype) in (np.float64, np.complex128)
    gh, ct = _common_geometry(max(v.size for _, _, v in per_shard), E, f64)
    mats = []
    for s, (lrows, cols_g, vals) in enumerate(per_shard):
        is_int = cols_g // chunk == s
        cols_e = cols_g - s * chunk
        cols_e[~is_int] = chunk + halo_pos[s]

        def conv(rr, cc, vv, ct=ct, **kw):
            return coo_to_whell(CooMatrix(rr, cc, vv, E, E), device="cpu",
                                packed=True, group_hacks=gh, chunk_tiles=ct,
                                scattered=scattered, **kw)

        if not split_exterior:
            mats.append(conv(lrows, cols_e, vals))
            continue
        pin = dict(row_degrees=np.bincount(lrows, minlength=E).astype(np.int64),
                   lane_capacity=max(8.0, 1.25 * vals.size / max(E, 1)))
        m_int = conv(lrows[is_int], cols_e[is_int], vals[is_int], **pin)
        # the exterior holds the halo entries only: the smallest tested
        # chunk keeps its per-group floor of tiles small
        m_ext = conv(lrows[~is_int], cols_e[~is_int], vals[~is_int],
                     ct=16 if f64 else 32, **pin)
        if not torch.equal(m_int.lane_of_row, m_ext.lane_of_row):
            raise ValueError("interior/exterior lane maps diverged despite "
                             "pinned degrees")
        mats.append((m_int, m_ext))
    return mats, send, chunk, K, halo_counts


def live_prefix(m: WhellMatrix) -> Optional[WhellMatrix]:
    """``m`` cut after its last output group whose tiles hold a nonzero
    value: the same product on that prefix of lane space (``n_rows``
    shrinks, ``n_cols`` stays), or None when no tile holds one.  Each kept
    group keeps all its chunks, so every output lane of the prefix is
    written."""
    T, ct, gh = m.num_tiles, m.chunk_tiles, m.group_hacks
    live = (m.values.reshape(T, -1) != 0).any(dim=1)
    if not bool(live.any()):
        return None
    grp = m.chunk_group[:-1].long()[torch.arange(T, device=m.device) // ct]
    G = int(grp[live].max()) + 1
    if G == m.num_groups:
        return m
    chunks = int((m.chunk_group[:-1] < G).sum())
    t = chunks * ct
    hacks = min(m.num_hacks, G * gh)
    return dataclasses.replace(
        m, values=m.values[: 8 * t], residue=m.residue[: 8 * t],
        page_tab=m.page_tab[: 8 * t], tile_base=m.tile_base[:t],
        tile_page=m.tile_page[:t],
        chunk_group=torch.cat([m.chunk_group[:chunks], m.chunk_group[-1:]]),
        seg_lo=m.seg_lo[: G * gh], seg_hi=m.seg_hi[: G * gh],
        lane_of_row=m.lane_of_row[:0], orig_rows=0, n_rows=hacks * _HACK,
        num_hacks=hacks, num_groups=G, total_slots=8 * t)


@dataclasses.dataclass
class PackedShard:
    """One shard's part of a :class:`PackedPartition`: its layouts, its
    lane map and its side of the exchange plan."""

    #: the interior slab (``overlap=True``) or the one slab of the shard
    interior: WhellMatrix
    #: the exterior slab cut by :func:`live_prefix`; None without one
    exterior: Optional[WhellMatrix]
    #: requester -> this shard's lanes it sends there (int64), pairs with
    #: a halo only, ascending requester
    send_lanes: Dict[int, torch.Tensor]
    #: owner -> this shard's halo lanes that owner's values land in
    halo_lanes: Dict[int, torch.Tensor]
    #: rows of the global matrix this shard owns
    n_local: int

    @property
    def lane_of_row(self) -> torch.Tensor:
        """Extended-space coordinate -> lane, ``(chunk + S*K,)`` int32."""
        return self.interior.lane_of_row

    @property
    def n_lane(self) -> int:
        """The shard's lane-space length (its Krylov state width)."""
        return self.interior.n_rows

    def to(self, device) -> "PackedShard":
        """A copy with every layout and index on ``device``."""
        return PackedShard(
            interior=self.interior.to(device),
            exterior=None if self.exterior is None else self.exterior.to(device),
            send_lanes={r: t.to(device) for r, t in self.send_lanes.items()},
            halo_lanes={p: t.to(device) for p, t in self.halo_lanes.items()},
            n_local=self.n_local)


@dataclasses.dataclass
class PackedPartition:
    """A row-partitioned square matrix: one :class:`PackedShard` per
    shard (on the CPU; :meth:`shard` places one on a device), the split
    and the exchange plan's counts."""

    shards: List[PackedShard]
    n_rows: int
    chunk: int
    halo_width: int  # K: the halo slots of each owner in the extended space
    nnz: int
    #: ``halo_counts[p][s]``: the lanes owner ``p`` sends requester ``s``
    halo_counts: tuple
    overlapped: bool

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def dtype(self) -> torch.dtype:
        """The vectors' type: float32 for float32 or bf16 slabs, else the
        slab's."""
        v = self.shards[0].interior.values.dtype
        return torch.float32 if v == torch.bfloat16 else v

    @property
    def no_halo(self) -> bool:
        """No shard needs a halo (one shard, or a block-diagonal matrix)."""
        return not any(c for row in self.halo_counts for c in row)

    def rows_of(self, s: int) -> slice:
        """The global rows shard ``s`` owns."""
        return slice(s * self.chunk, s * self.chunk + self.shards[s].n_local)

    def shard(self, s: int, device) -> PackedShard:
        """Shard ``s`` placed on ``device``."""
        return self.shards[s].to(device)

    def embed_shard(self, x, s: int, device=None, fill=0) -> torch.Tensor:
        """Global ``(n,)`` vector -> shard ``s``'s lane-space block (phantom
        and padding lanes ``fill``), in the partition's type, on
        ``device`` (default: the CPU)."""
        sh = self.shards[s]
        x = torch.as_tensor(np.asarray(x)[self.rows_of(s)])
        out = torch.full((sh.n_lane,), fill, dtype=self.dtype)
        out[sh.lane_of_row[: sh.n_local].long()] = x.to(self.dtype)
        return out.to(device or "cpu")

    def extract_shard(self, z: torch.Tensor, s: int) -> torch.Tensor:
        """Shard ``s``'s lane-space block -> its rows of the global vector."""
        sh = self.shards[s]
        return z[sh.lane_of_row[: sh.n_local].to(z.device).long()]

    def embed(self, x) -> List[torch.Tensor]:
        """Global ``(n,)`` vector -> every shard's lane-space block (CPU)."""
        return [self.embed_shard(x, s) for s in range(self.n_shards)]

    def extract(self, zs) -> torch.Tensor:
        """Every shard's lane-space block -> the global ``(n,)`` vector."""
        return torch.cat([self.extract_shard(z, s).cpu() for s, z in enumerate(zs)])


def _shard_plan(mats_lor, send, chunk: int, K: int, halo_counts, s: int):
    """Shard ``s``'s send lanes (to each requester with a halo) and halo
    lanes (from each owner with one), from every shard's lane map."""
    S = len(mats_lor)
    send_lanes = {r: mats_lor[s][torch.from_numpy(send[s][r])].long()
                  for r in range(S) if halo_counts[s][r]}
    halo_lanes = {p: mats_lor[s][chunk + p * K + torch.arange(halo_counts[p][s])].long()
                  for p in range(S) if halo_counts[p][s]}
    return send_lanes, halo_lanes


def partition_coo_rows_packed(coo: CooMatrix, n_shards: int, overlap: bool = True,
                              scattered: Optional[bool] = None) -> PackedPartition:
    """Build a :class:`PackedPartition` of a square host COO (float32,
    float64, complex64 or complex128 values) on the CPU.

    ``overlap=True`` (default) splits each shard into interior and
    exterior slabs sharing one lane space, so the distributed SpMV runs
    the interior product while the halo is exchanged; ``overlap=False``
    keeps one slab, which runs after the exchange.  ``scattered`` as in
    :func:`build_shard_mats`."""
    mats, send, chunk, K, halo_counts = build_shard_mats(
        coo, n_shards, split_exterior=overlap, scattered=scattered)
    interior = [m[0] if overlap else m for m in mats]
    lors = [m.lane_of_row for m in interior]
    shards = []
    for s in range(n_shards):
        send_lanes, halo_lanes = _shard_plan(lors, send, chunk, K, halo_counts, s)
        shards.append(PackedShard(
            interior=interior[s],
            exterior=live_prefix(mats[s][1]) if overlap else None,
            send_lanes=send_lanes, halo_lanes=halo_lanes,
            n_local=max(0, min(chunk, coo.n_rows - s * chunk))))
    return PackedPartition(shards=shards, n_rows=coo.n_rows, chunk=chunk,
                           halo_width=K, nnz=coo.nnz, halo_counts=halo_counts,
                           overlapped=overlap)


# --- the bridge from a JAX partition -------------------------------------

def _shard_fields(fields: dict, prefix: str, s: int, ng: int, ct: int,
                  window_pages: int) -> dict:
    """Shard ``s``'s arrays of one slab family (``prefix`` "" or "ext_")
    of a stacked JAX partition, its stacking pad dropped: chunks of groups
    past the shard's ``ng``, the repeated padding chunks of its last group
    (trailing chunks of zero tiles past its first), and padded
    superpage-table entries (an empty slab has none: the converter builds
    it aligned)."""
    get = lambda name: None if fields.get(prefix + name) is None \
        else np.asarray(fields[prefix + name][s])  # noqa: E731
    cg, tb, vals = get("chunk_group")[:-1], get("tile_base"), get("values")
    last = np.flatnonzero(cg == ng - 1)
    keep = int(last[0]) + 1
    for c in last[1:]:
        if tb[c * ct:(c + 1) * ct].any() or vals[c * ct * 8:(c + 1) * ct * 8].any():
            keep = int(c) + 1
    t = keep * ct
    out = {name: get(name)[: 8 * t] for name in ("values", "values_lo", "residue",
                                                  "page_tab") if get(name) is not None}
    out.update(tile_base=tb[:t], chunk_group=np.r_[cg[:keep], np.int32(-1)])
    gb = get("group_bases")
    if gb is not None and (out["values"].any() or tb[:t].any()):
        groups = int((tb[:t] & ((1 << 20) - 1)).max()) + 1
        out["group_bases"] = gb[: groups * (window_pages // 8)]
    return out


def from_numpy_partition(fields: dict, im: Optional[dict] = None, **static
                         ) -> PackedPartition:
    """The port's :class:`PackedPartition` from a JAX ``PackedPartition``:
    ``fields`` its array fields (``np.asarray`` of each, the leading
    shard axis kept) and ``static`` its static fields; for a JAX
    ``ComplexPackedPartition`` ``fields`` are the ``ar`` plane's and
    ``im`` the ``ai`` plane's, joined into complex slabs (each
    double-float plane joined first; the planes must share their
    structure).

    Each shard is sliced out of the stacked arrays and its stacking pad
    dropped: its own lane space (``num_hacks`` from its lane map), its
    own groups and chunks.  Its exterior is cut by :func:`live_prefix`;
    its exchange plan is the JAX ``send_lane_idx`` and ``halo_lanes``
    trimmed to the real counts.  Layouts on the CPU, each checked."""
    S, chunk, K = static["n_shards"], static["chunk"], static["halo_width"]
    gh, counts = static["group_hacks"], static["halo_counts"]
    lor_all = np.asarray(fields["lane_of_row"])
    overlapped = fields.get("ext_values") is not None
    shards = []
    for s in range(S):
        lor = lor_all[s]
        hacks = int(lor.max()) // _HACK + 1
        ng = -(-hacks // gh)
        scattered_x = fields.get("group_bases") is not None
        w = static["window_pages"]
        x_pages = max(-(-hacks // 8) * 8, 8) if scattered_x else max(-(-hacks // w) * w, w)

        def layout(prefix, ct):
            planes = []
            for f in (fields, im) if im is not None else (fields,):
                sf = _shard_fields(f, prefix, s, ng, ct, w)
                sf.update(seg_lo=np.asarray(f["seg_lo"][s])[: ng * gh],
                          seg_hi=np.asarray(f["seg_hi"][s])[: ng * gh],
                          lane_of_row=lor)
                planes.append(sf)
            meta = dict(n_rows=hacks * _HACK, n_cols=hacks * _HACK, num_hacks=hacks,
                        num_groups=ng, total_slots=planes[0]["values"].shape[0],
                        nnz=int(np.count_nonzero(planes[0]["values"])),
                        x_pages=x_pages, window_pages=w, orig_rows=lor.size,
                        group_hacks=gh, chunk_tiles=ct,
                        unit_segments=static.get("unit_segments", False))
            if im is None:
                return from_numpy_fields(planes[0], **meta)
            return from_numpy_planes(*planes, **meta)

        interior = layout("", static["chunk_tiles"])
        exterior = (live_prefix(layout("ext_", static["ext_chunk_tiles"]))
                    if overlapped else None)
        send_lanes = {r: torch.from_numpy(np.asarray(fields["send_lane_idx"][s, r])
                                          [: counts[s][r]].astype(np.int64))
                      for r in range(S) if counts[s][r]}
        halo = np.asarray(fields["halo_lanes"][s]).astype(np.int64)
        halo_lanes = {p: torch.from_numpy(halo[p * K: p * K + counts[p][s]])
                      for p in range(S) if counts[p][s]}
        n_local = max(0, min(chunk, static["n_rows"] - s * chunk))
        shards.append(PackedShard(interior, exterior, send_lanes, halo_lanes, n_local))
    return PackedPartition(shards=shards, n_rows=static["n_rows"], chunk=chunk,
                           halo_width=K, nnz=static["nnz"], halo_counts=counts,
                           overlapped=overlapped)
