"""The float64 packed WHELL geometry sweep: kernel #4 at six
``(group_hacks, chunk_tiles)`` geometries on the card.

The port of ``doc/sweeps/dd_geom_sweep.py``: ``laplacian_2d(512, 512,
float64)`` through ``coo_to_whell(..., scattered=False, group_hacks=gh,
chunk_tiles=ct)`` (the JAX script's aligned 32-page windows) for each
geometry of :data:`GEOMETRIES`, the
product ``whell_packed_spmv`` (#4) held against the float64 host golden
at 1e-12·max|z| and timed warm and cold, with the layout's padding and
#4's bound on it.  A geometry that fails raises: there is no compiler
budget to fail here, as Mosaic's was on the TPU.

    python -m spgpu_tpu_torch.sweeps.dd_geom_sweep [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch.convert import coo_to_whell
from spgpu_tpu_torch.kernels import whell as kw
from spgpu_tpu_torch.ops import _prep_x
from spgpu_tpu_torch.sweeps import _common as c
from spgpu_tpu_torch.utils.fixtures import laplacian_2d
from spgpu_tpu_torch.utils.measure import bound, check_close, nbytes

__all__ = ["GEOMETRIES", "SIDE", "main", "run"]

#: the JAX script's Laplacian side and its (group_hacks, chunk_tiles)
SIDE = 512
GEOMETRIES = ((128, 32), (128, 64), (256, 32), (256, 64), (512, 32), (512, 64))

#: #4's kernel, by the name the profiler gives it
KERNELS = ("whell_hack_pass",)


def run(device="cuda", *, size: int = SIDE) -> dict:
    """The sweep on ``device`` (``cuda``, which must exist, or ``cpu``) on
    the ``size`` x ``size`` float64 Laplacian: one row per geometry, and
    the cuSPARSE CSR call on the matrix."""
    dev = c.sweep_device(device)
    coo = laplacian_2d(size, size, np.float64)
    x = np.random.default_rng(0).standard_normal(coo.n_cols)
    golden = torch.from_numpy(coo.spmv(x))
    xo = torch.from_numpy(x).to(dev)
    kernels, plains, layouts = {}, {}, {}
    before = kw.LAUNCHES_F64
    errs = {}
    for geom in GEOMETRIES:
        gh, ct = geom
        a = coo_to_whell(coo, device=dev, scattered=False, group_hacks=gh,
                         chunk_tiles=ct)
        x2 = _prep_x(a.embed(xo, dtype=torch.float64), a.n_cols, a.x_pages)
        args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
                a.group_bases, a.seg_lo, a.seg_hi, x2)
        static = dict(chunk_tiles=ct, group_hacks=gh, window_pages=a.window_pages,
                      unit_segments=a.unit_segments, hack_units=a.hack_units,
                      tile_page=a.tile_page)
        kernels[geom] = lambda args=args, static=static: kw.whell_packed_spmv(*args, **static)
        plains[geom] = lambda args=args, static=static: kw.whell_packed_spmv_plain(*args, **static)
        z = a.extract(kernels[geom]().reshape(-1)[: a.n_rows], dtype=torch.float64)
        errs[geom] = check_close(z, golden, 0, 1e-12, f"#4 at gh={gh} ct={ct} vs golden")
        layouts[geom] = (a, args)
    launches = kw.LAUNCHES_F64 - before
    times = c.time_calls(dev, kernels, {g: KERNELS for g in GEOMETRIES}, plains,
                         lambda: c.csr_call(coo, xo))
    rows = []
    for geom in GEOMETRIES:
        a, args = layouts[geom]
        z_bytes = a.seg_lo.shape[0] * 128 * 8
        # #4 reads hack_units, not chunk_group; the unit scan reads seg_hi alone
        moved = (nbytes(*args) - nbytes(a.chunk_group) + nbytes(a.hack_units)
                 - a.unit_segments * nbytes(a.seg_lo) + z_bytes)
        rows.append(dict(group_hacks=geom[0], chunk_tiles=geom[1],
                         tiles=a.num_tiles, num_groups=a.num_groups,
                         padding=a.total_slots * 128 / coo.nnz,
                         output_bytes=z_bytes, level_bytes=moved,
                         max_abs_err=errs[geom], **times[geom],
                         **c.rates(times[geom]["device_ms"], coo.nnz, a.num_tiles),
                         **bound(moved, 2 * coo.nnz, "float64")))
    best = min(rows, key=lambda r: r["bound_bytes"])
    return dict(
        sweep="dd_geom_sweep", kernel="#4 whell_packed_spmv_f64 (csrc/whell_packed_spmv.cu)",
        fixture=f"laplacian_2d({size}, {size}, float64)", **c.card(dev),
        rows=coo.n_rows, nnz=coo.nnz, window_pages=a.window_pages,
        geometries=rows, launches=launches, max_abs_err=max(errs.values()),
        bound_of=f"#4 at the least-padded geometry (gh={best['group_hacks']} "
                 f"ct={best['chunk_tiles']})",
        bound={k: best[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_flops")},
        library_call="torch.sparse_csr_tensor @ x (cuSPARSE CSR), float64",
        library=times["library"])


def print_result(res: dict) -> None:
    c.print_result(res, f"lap{int(res['rows'] ** 0.5)} float64 geometry sweep, "
                        f"wp={res['window_pages']}, launches={res['launches']} "
                        f"on {res['device']}",
                   lambda r: (f"gh={r['group_hacks']} ct={r['chunk_tiles']}: pad "
                              f"{r['padding']:.2f}x tiles {r['tiles']} bound "
                              f"{r['bound_ms']:.4f} ms"),
                   rows_key="geometries")


def main() -> dict:
    return c.cli(run, __doc__, print_result)


if __name__ == "__main__":
    main()
