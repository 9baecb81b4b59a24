"""Kernel #18: the per-op cycle account of the WHDIA SpMV (#3) in pattern
mode, fp32, at the production geometry.

The port of ``doc/sweeps/whdia_ablation.py``: banded-11 at 524,288 rows
(``random_banded(2**19, 11, wander=7, seed=2)`` with duplicates summed:
pattern mode, 8,192 tiles), x ~ N(0, 1) from ``default_rng(0)``.  The
levels of :data:`~spgpu_tpu_torch.kernels.ablation.WHDIA_LEVELS` add one
op family of #3's tile pass at a time (stream, r0, gather, full); each is
held against its plain version (fp32: 1e-5·max|out|; full: #3's rtol
1e-5 and 1e-5·max|z|) and ``full`` against the production
``whdia_spmv`` launch.  Each row's price is its device time less the
row before's: the family it adds.  The partial levels store 512 B per
tile (``part``), which ``full`` does not: the rows give the bytes.

    python -m spgpu_tpu_torch.sweeps.whdia_ablation [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch.convert import coo_to_whdia
from spgpu_tpu_torch.kernels import ablation as ab
from spgpu_tpu_torch.kernels import whdia as kd
from spgpu_tpu_torch.sweeps import _common as c
from spgpu_tpu_torch.utils.fixtures import random_banded
from spgpu_tpu_torch.utils.measure import HBM_BYTES_PER_S, bound, check_close, nbytes

__all__ = ["ROWS", "fixture", "main", "run"]

#: the JAX script's banded-11 rows
ROWS = 1 << 19

#: each level's own kernels, by the names the profiler gives them
KERNELS = {"stream": ("whdia_ablation_pass",), "r0": ("whdia_ablation_pass",),
           "gather": ("whdia_ablation_pass",), "full": ("whdia_tile_pass",)}


def fixture(rows: int = ROWS):
    """The JAX script's banded-11 matrix at ``rows`` rows, duplicates
    summed."""
    return random_banded(rows, bands=11, wander=7, seed=2,
                         dtype=np.float32).sum_duplicates()


def run(device="cuda", *, size: int = ROWS) -> dict:
    """The account on ``device`` (``cuda``, which must exist, or ``cpu``)
    at ``size`` rows: one row per card level, the absent TPU levels, the
    bound of #3 on the fixture and the cuSPARSE CSR call on it."""
    dev = c.sweep_device(device)
    coo = fixture(size)
    a = coo_to_whdia(coo, device=dev)
    if not a.pattern_mode:
        raise ValueError("whdia_ablation: the fixture must convert in pattern mode")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(coo.n_cols)
                         .astype(np.float32)).to(dev)
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, x)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups)
    kernels = {lv: (lambda lv=lv: ab.whdia_ablation(lv, *args, **static))
               for lv in ab.WHDIA_LEVELS}
    plains = {lv: (lambda lv=lv: ab.whdia_ablation_plain(lv, *args, **static))
              for lv in ab.WHDIA_LEVELS}

    before = ab.LAUNCHES_WHDIA_ABLATION
    outs = {lv: fn() for lv, fn in kernels.items()}
    launches = ab.LAUNCHES_WHDIA_ABLATION - before
    errs = {lv: check_close(outs[lv], plains[lv](), *tol, f"#18 {lv} vs plain")
            for lv, tol in (("stream", (0, 1e-5)), ("r0", (0, 1e-5)),
                            ("gather", (0, 1e-5)), ("full", (1e-5, 1e-5)))}
    err_prod = check_close(outs["full"], kd.whdia_spmv(*args, **static),
                             1e-5, 1e-5, "#18 full vs whdia_spmv")

    T = a.num_tiles
    z_rows = a.num_groups * a.group_hacks * 128
    part = T * 128 * 4
    r0 = nbytes(a.slot_r0, a.tile_r0, a.tile_base)
    moved = {"stream": nbytes(a.values) + part,
             "r0": nbytes(a.values) + r0 + part,
             "gather": nbytes(a.values, x) + r0 + part,
             "full": nbytes(a.values, x, a.chunk_group) + r0 + z_rows * 4}
    times = c.time_calls(dev, kernels, KERNELS, plains, lambda: c.csr_call(coo, x))
    tpu = ab.TPU_LEVELS["whdia"]
    rows = [dict(level=lv, adds=ab.LEVEL_ADDS["whdia"][lv],
                 tpu_levels=[t for t, (card, _) in tpu.items() if card == lv],
                 output="z (num_groups*group_hacks*128,)" if lv == "full"
                 else "part (num_tiles, 128)",
                 output_bytes=z_rows * 4 if lv == "full" else part,
                 level_bytes=moved[lv],
                 level_bound_ms=1e3 * moved[lv] / HBM_BYTES_PER_S,
                 max_abs_err=errs[lv], **times[lv],
                 **c.rates(times[lv]["device_ms"], coo.nnz, T))
            for lv in ab.WHDIA_LEVELS]
    c.add_prices(rows)
    return dict(
        sweep="whdia_ablation", kernel="#18 whdia_ablation (csrc/whdia_spmv.cu)",
        fixture=f"random_banded({size}, 11, wander=7, seed=2).sum_duplicates(), "
                "float32", **c.card(dev),
        rows=coo.n_rows, nnz=coo.nnz, tiles=T, group_hacks=a.group_hacks,
        chunk_tiles=a.chunk_tiles, window_pages=a.window_pages,
        padding=a.total_slots * 128 / coo.nnz, mode="pattern",
        levels=rows, launches=launches,
        max_abs_err=max(errs.values()), full_vs_production_max_abs_err=err_prod,
        absent=[dict(tpu_level=t, reason=why) for t, (card, why) in tpu.items()
                if card is None],
        tpu_levels={t: card for t, (card, _) in tpu.items()},
        bound_of="#3 whdia_spmv on the fixture",
        bound=bound(moved["full"], 2 * coo.nnz, "float32"),
        library_call="torch.sparse_csr_tensor @ x (cuSPARSE CSR), float32",
        library=times["library"])


def print_result(res: dict) -> None:
    c.print_result(res, f"banded-11 {res['rows']}: tiles={res['tiles']} "
                        f"gh={res['group_hacks']} ct={res['chunk_tiles']} "
                        f"wp={res['window_pages']} pad={res['padding']:.2f} "
                        f"launches={res['launches']} on {res['device']}",
                   lambda r: f"{r['level']:8s}")


def main() -> dict:
    return c.cli(run, __doc__, print_result)


if __name__ == "__main__":
    main()
