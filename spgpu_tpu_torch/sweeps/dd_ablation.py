"""Kernel #19: the per-op cycle account of the float64 packed WHELL SpMV
(#4) at the production geometry.

The port of ``doc/sweeps/dd_ablation.py``: ``laplacian_2d(512, 512,
float64)`` (the JAX script's matrix) or, with ``matrix="flagship"``, the
flagship ``random_fem_like(262144, 27.0, span=768, far_frac=0.01,
seed=0)`` in float64, through ``coo_to_whell`` at its default float64
geometry, lane-space x ~ N(0, 1) from ``default_rng(0)``.  The levels of
:data:`~spgpu_tpu_torch.kernels.ablation.F64_LEVELS` add one op family of
#4's hack pass at a time (stream, gather, own, full); each is held
against its plain version at 1e-12·max|out| and ``full`` against the
production ``whell_packed_spmv`` launch.  Each row's price is its device
time less the row before's.  The stream and gather levels store 1 KiB
per tile (``part``); the rows give the bytes.  The TPU levels eft, ddrmw
and norelax price double-float arithmetic, which the port does not have,
and the tile pass's atomic level priced atomics that the hack pass does
not have: they are listed as absent, with the reason, and never timed.

    python -m spgpu_tpu_torch.sweeps.dd_ablation [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch.convert import coo_to_whell
from spgpu_tpu_torch.kernels import ablation as ab
from spgpu_tpu_torch.kernels import whell as kw
from spgpu_tpu_torch.ops import _prep_x
from spgpu_tpu_torch.sweeps import _common as c
from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_fem_like
from spgpu_tpu_torch.utils.measure import HBM_BYTES_PER_S, bound, check_close, nbytes

__all__ = ["SIDE", "main", "run"]

#: the JAX script's Laplacian side, and the flagship's rows
SIDE = 512
FLAGSHIP_ROWS = 262144

#: every level's kernel, by the name the profiler gives it
KERNELS = {lv: ("whell_hack_pass",) for lv in ab.F64_LEVELS}


def fixture(matrix: str, size: int):
    """The account's float64 matrix and its name: the ``size`` x ``size``
    Laplacian, or the flagship FEM-like matrix of ``size`` rows."""
    if matrix == "laplacian":
        return laplacian_2d(size, size, np.float64), f"laplacian_2d({size}, {size}, float64)"
    if matrix == "flagship":
        return (random_fem_like(size, 27.0, span=768, far_frac=0.01, seed=0,
                                dtype=np.float64),
                f"random_fem_like({size}, 27.0, span=768, far_frac=0.01, "
                "seed=0), float64")
    raise ValueError(f"matrix must be 'laplacian' or 'flagship', not {matrix!r}")


def run(device="cuda", *, size: int = None, matrix: str = "laplacian") -> dict:
    """The account on ``device`` (``cuda``, which must exist, or ``cpu``)
    on ``matrix``: the ``size`` x ``size`` float64 Laplacian (default
    :data:`SIDE`) or the flagship of ``size`` rows (default
    :data:`FLAGSHIP_ROWS`): one row per card level, the absent levels with
    their reasons, the bound of #4 on the fixture and the cuSPARSE CSR
    call on it."""
    dev = c.sweep_device(device)
    if size is None:
        size = SIDE if matrix == "laplacian" else FLAGSHIP_ROWS
    coo, name = fixture(matrix, size)
    a = coo_to_whell(coo, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(a.n_cols)).to(dev)
    x2 = _prep_x(x, a.n_cols, a.x_pages)
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, x2)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  hack_units=a.hack_units)
    kernels = {lv: (lambda lv=lv: ab.whell_f64_ablation(lv, *args, **static))
               for lv in ab.F64_LEVELS}
    plains = {lv: (lambda lv=lv: ab.whell_f64_ablation_plain(lv, *args, **static))
              for lv in ab.F64_LEVELS}

    before = ab.LAUNCHES_F64_ABLATION
    outs = {lv: fn() for lv, fn in kernels.items()}
    launches = ab.LAUNCHES_F64_ABLATION - before
    errs = {lv: check_close(outs[lv], plains[lv](), 0, 1e-12,
                              f"#19 {lv} vs plain") for lv in ab.F64_LEVELS}
    err_prod = check_close(outs["full"], kw.whell_packed_spmv(*args, **static),
                             0, 1e-12, "#19 full vs whell_packed_spmv")

    T = a.num_tiles
    R = a.seg_lo.shape[0]
    part = T * 128 * 8
    cells = nbytes(a.values, a.residue, a.page_tab, a.hack_units)
    decode = nbytes(a.tile_base, a.group_bases, x2)
    # the unit scan reads seg_hi alone
    segs = nbytes(a.seg_hi) + (0 if a.unit_segments else nbytes(a.seg_lo))
    moved = {"stream": cells + part,
             "gather": cells + decode + part,
             "own": cells + decode + R * 128 * 8,
             "full": cells + decode + segs + R * 128 * 8}
    times = c.time_calls(dev, kernels, KERNELS, plains,
                         lambda: c.csr_call(coo, x[a.lane_of_row.long()]))
    tpu = ab.TPU_LEVELS["f64"]
    out_kind = {"stream": "part (num_tiles, 128)", "gather": "part (num_tiles, 128)",
                "own": "hack sums (num_groups*group_hacks, 128)",
                "full": "z (num_groups*group_hacks, 128)"}
    rows = [dict(level=lv, adds=ab.LEVEL_ADDS["f64"][lv],
                 tpu_levels=[t for t, (card, _) in tpu.items() if card == lv],
                 output=out_kind[lv],
                 output_bytes=part if lv in ("stream", "gather") else R * 128 * 8,
                 level_bytes=moved[lv],
                 level_bound_ms=1e3 * moved[lv] / HBM_BYTES_PER_S,
                 max_abs_err=errs[lv], **times[lv],
                 **c.rates(times[lv]["device_ms"], coo.nnz, T))
            for lv in ab.F64_LEVELS]
    c.add_prices(rows)
    return dict(
        sweep="dd_ablation",
        kernel="#19 whell_packed_ablation_f64 (csrc/whell_packed_spmv.cu)",
        matrix=matrix, fixture=name, **c.card(dev),
        rows=coo.n_rows, nnz=coo.nnz, tiles=T, group_hacks=a.group_hacks,
        chunk_tiles=a.chunk_tiles, window_pages=a.window_pages,
        scattered=a.scattered,
        padding=a.total_slots * 128 / coo.nnz, unit_segments=a.unit_segments,
        levels=rows, launches=launches,
        max_abs_err=max(errs.values()), full_vs_production_max_abs_err=err_prod,
        absent=[dict(tpu_level=t, reason=why) for t, (card, why) in tpu.items()
                if card is None],
        retired=[dict(level=lv, reason=why)
                 for lv, why in ab.RETIRED_LEVELS["f64"].items()],
        tpu_levels={t: card for t, (card, _) in tpu.items()},
        bound_of="#4 whell_packed_spmv_f64 on the fixture",
        bound=bound(moved["full"], 2 * coo.nnz, "float64"),
        library_call="torch.sparse_csr_tensor @ x (cuSPARSE CSR), float64",
        library=times["library"])


def print_result(res: dict) -> None:
    c.print_result(res, f"{res['fixture']}: tiles={res['tiles']} "
                        f"gh={res['group_hacks']} ct={res['chunk_tiles']} "
                        f"wp={res['window_pages']} pad={res['padding']:.2f} "
                        f"launches={res['launches']} on {res['device']}",
                   lambda r: f"{r['level']:8s}")


def main() -> dict:
    return c.cli(run, __doc__, print_result)


if __name__ == "__main__":
    main()
