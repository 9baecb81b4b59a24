"""Kernel #18: the per-op cycle account of the fp32 WHDIA SpMV (#3), at
the production geometry, on both DIA fixtures, in two level sets.

The port of ``doc/sweeps/whdia_ablation.py``: banded-11 at 524,288 rows
(``random_banded(2**19, 11, wander=7, seed=2)`` with duplicates summed:
pattern mode, 8,192 tiles), and (``matrix="laplace"``) the 2-D Laplacian
the JAX benchmark runs (``laplacian_2d(1024, 1024)``: slab mode), x ~
N(0, 1) from ``default_rng(0)``.

* ``family="tile"``: the levels of
  :data:`~spgpu_tpu_torch.kernels.ablation.WHDIA_LEVELS` add one op family
  of the fp32 tile pass at a time (stream, r0, gather, full): the design
  #3 ran before it read only the live slots (and #6 and #10 before they
  did).  Each is
  held against its plain version (fp32: 1e-5·max|out|; full: #3's rtol
  1e-5 and 1e-5·max|z|), and ``full`` against the production #3 (the
  warp pass over the live slots, so within the same tolerance).  The
  partial levels store 512 B per tile (``part``), which ``full`` does not:
  the rows give the bytes.
* ``family="hack"``: the levels of
  :data:`~spgpu_tpu_torch.kernels.ablation.HACK_LEVELS` (launch, list,
  stream, full) of the production #3 at 1 RHS and of #13 at 8 RHS
  (``default_rng(3)``), over the layout's live slots; each held against
  its plain version (launch and list exactly, stream 1e-5·max|out|, full
  #3's tolerance) and ``full`` against the production launch, bit for bit
  on the card.

Each row's price is its device time less the row before's (of the same
RHS count): the family it adds.

    python -m spgpu_tpu_torch.sweeps.whdia_ablation [--device cpu]
        [--matrix banded11|laplace] [--family tile|hack]
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch.convert import coo_to_whdia
from spgpu_tpu_torch.kernels import ablation as ab
from spgpu_tpu_torch.kernels import whdia as kd
from spgpu_tpu_torch.sweeps import _common as c
from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded
from spgpu_tpu_torch.utils.measure import HBM_BYTES_PER_S, bound, check_close, nbytes

__all__ = ["FAMILIES", "LAP_SIDE", "MATRICES", "ROWS", "SPMM_RHS", "fixture",
           "main", "run"]

#: the JAX script's banded-11 rows, and the side of the JAX benchmark's
#: Laplacian
ROWS = 1 << 19
LAP_SIDE = 1024
#: the fixtures (each converts in its r0 mode) and the level sets
MATRICES = {"banded11": "pattern", "laplace": "slab"}
FAMILIES = ("tile", "hack")
#: the RHS of the hack levels' second run (#13's, as the JAX SpMM row)
SPMM_RHS = 8

#: each level's own kernels, by the names the profiler gives them
KERNELS = {"stream": ("whdia_ablation_pass",), "r0": ("whdia_ablation_pass",),
           "gather": ("whdia_ablation_pass",), "full": ("whdia_tile_pass",)}
HACK_KERNELS = {1: {"launch": ("whdia_warps_ablation",),
                    "list": ("whdia_warps_ablation",),
                    "stream": ("whdia_warps_ablation",),
                    "full": ("whdia_spmv_warps",)},
                SPMM_RHS: {"launch": ("whdia_hack_ablation",),
                           "list": ("whdia_hack_ablation",),
                           "stream": ("whdia_hack_ablation",),
                           "full": ("whdia_hack_pass",)}}


def fixture(size: int = ROWS, matrix: str = "banded11"):
    """The fixture: the JAX script's banded-11 matrix at ``size`` rows,
    duplicates summed, or the 2-D Laplacian of side ``size``; fp32."""
    if matrix == "laplace":
        return laplacian_2d(size, size, np.float32)
    return random_banded(size, bands=11, wander=7, seed=2,
                         dtype=np.float32).sum_duplicates()


def run(device="cuda", *, size: int = None, matrix: str = "banded11",
        family: str = "tile") -> dict:
    """The account on ``device`` (``cuda``, which must exist, or ``cpu``)
    on ``matrix`` at ``size`` (rows of banded-11, the Laplacian's side;
    the JAX sizes by default): one row per card level of ``family`` (the
    hack levels at 1 and at :data:`SPMM_RHS` RHS), the absent TPU levels,
    the bound of #3 on the fixture and the cuSPARSE CSR call on it."""
    if matrix not in MATRICES or family not in FAMILIES:
        raise ValueError(f"whdia_ablation: matrix must be one of {tuple(MATRICES)} "
                         f"and family one of {FAMILIES}, not {matrix!r}, {family!r}")
    dev = c.sweep_device(device)
    size = size or (LAP_SIDE if matrix == "laplace" else ROWS)
    coo = fixture(size, matrix)
    a = coo_to_whdia(coo, device=dev)
    mode = "pattern" if a.pattern_mode else "slab"
    if mode != MATRICES[matrix]:
        raise ValueError(f"whdia_ablation: {matrix} converted in {mode} mode, "
                         f"not {MATRICES[matrix]}")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(coo.n_cols)
                         .astype(np.float32)).to(dev)
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, tile_page=a.tile_page)
    lists = dict(hack_slot_ptr=a.hack_slot_ptr, hack_slots=a.hack_slots)
    rows_of = _tile_rows if family == "tile" else _hack_rows
    rows, launches, err_prod, more = rows_of(coo, a, args, static, lists, x, dev)
    key = "whdia" if family == "tile" else "whdia_hack"
    tpu = ab.TPU_LEVELS[key]
    for r in rows:
        r["tpu_levels"] = [t for t, (card, _) in tpu.items() if card == r["level"]]
    fixture_name = (f"laplacian_2d({size}, {size})" if matrix == "laplace" else
                    f"random_banded({size}, 11, wander=7, seed=2).sum_duplicates()")
    return dict(
        sweep="whdia_ablation", family=family, matrix=matrix,
        kernel="#18 whdia_ablation (csrc/whdia_spmv.cu)" if family == "tile" else
        "#18 whdia_hack_ablation (csrc/whdia_spmv.cu)",
        fixture=f"{fixture_name}, float32", **c.card(dev),
        rows=coo.n_rows, nnz=coo.nnz, tiles=a.num_tiles, group_hacks=a.group_hacks,
        chunk_tiles=a.chunk_tiles, window_pages=a.window_pages,
        padding=a.total_slots * 128 / coo.nnz, mode=mode,
        levels=rows, launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        full_vs_production_max_abs_err=err_prod,
        absent=[dict(tpu_level=t, reason=why) for t, (card, why) in tpu.items()
                if card is None],
        retired=[dict(level=lv, reason=why)
                 for lv, why in ab.RETIRED_LEVELS.get(key, {}).items()],
        tpu_levels={t: card for t, (card, _) in tpu.items()}, **more)


def _tile_rows(coo, a, args, static, lists, x, dev):
    """The tile levels' rows, the launches of their checked calls,
    ``full`` against the production #3, and the bound and library
    fields."""
    kernels = {lv: (lambda lv=lv: ab.whdia_ablation(lv, *args, x, **static))
               for lv in ab.WHDIA_LEVELS}
    plains = {lv: (lambda lv=lv: ab.whdia_ablation_plain(lv, *args, x, **static))
              for lv in ab.WHDIA_LEVELS}
    before = ab.LAUNCHES_WHDIA_ABLATION
    outs = {lv: fn() for lv, fn in kernels.items()}
    launches = ab.LAUNCHES_WHDIA_ABLATION - before
    errs = {lv: check_close(outs[lv], plains[lv](), *tol, f"#18 {lv} vs plain")
            for lv, tol in (("stream", (0, 1e-5)), ("r0", (0, 1e-5)),
                            ("gather", (0, 1e-5)), ("full", (1e-5, 1e-5)))}
    # the tile pass (atomics) against the production #3 (the warp pass over
    # the live slots): the same product, summed in other orders
    err_prod = check_close(outs["full"], kd.whdia_spmv(*args, x, **static, **lists),
                           1e-5, 1e-5, "#18 full (the tile pass) vs whdia_spmv (#3)")
    T = a.num_tiles
    z_rows = a.num_groups * a.group_hacks * 128
    part = T * 128 * 4
    r0 = nbytes(a.slot_r0, a.tile_r0, a.tile_base)
    moved = {"stream": nbytes(a.values) + part,
             "r0": nbytes(a.values) + r0 + part,
             "gather": nbytes(a.values, x) + r0 + part,
             "full": nbytes(a.values, x, a.chunk_group) + r0 + z_rows * 4}
    times = c.time_calls(dev, kernels, KERNELS, plains, lambda: c.csr_call(coo, x))
    rows = [dict(level=lv, adds=ab.LEVEL_ADDS["whdia"][lv],
                 output="z (num_groups*group_hacks*128,)" if lv == "full"
                 else "part (num_tiles, 128)",
                 output_bytes=z_rows * 4 if lv == "full" else part,
                 level_bytes=moved[lv],
                 level_bound_ms=1e3 * moved[lv] / HBM_BYTES_PER_S,
                 max_abs_err=errs[lv], **times[lv],
                 **c.rates(times[lv]["device_ms"], coo.nnz, T))
            for lv in ab.WHDIA_LEVELS]
    c.add_prices(rows)
    return rows, launches, err_prod, dict(
        full_vs_production="the tile pass's full level (atomics into a zeroed z) "
                           "against the production #3 (the warp pass)",
        bound_of="#3 whdia_spmv on the fixture, every slot (the tile pass)",
        bound=bound(moved["full"], 2 * coo.nnz, "float32"),
        library_call="torch.sparse_csr_tensor @ x (cuSPARSE CSR), float32",
        library=times["library"])


def _hack_rows(coo, a, args, static, lists, x, dev):
    """The hack levels' rows at 1 and :data:`SPMM_RHS` RHS, the launches
    of their checked calls, ``full`` against the production launches, and
    the bound and library fields."""
    xs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (SPMM_RHS, coo.n_cols)).astype(np.float32)).to(dev)
    hacks = a.num_groups * a.group_hacks
    live = (a.values != 0).any(dim=1)
    n_live = int(live.sum())
    live_tiles = int(live.view(-1, 8).any(dim=1).sum())
    head = 4 * (hacks + 1)  # the list bounds
    chain = n_live * (4 + (0 if a.pattern_mode else 2)) \
        + live_tiles * 4 * (2 if a.pattern_mode else 1)  # entries, r0, tile words
    rows, launches, err_prod, bounds, library = [], 0, 0.0, {}, {}
    for n_rhs, xr in ((1, x), (SPMM_RHS, xs)):
        def kernel(lv, xr=xr):
            return ab.whdia_hack_ablation(lv, *args, xr, **static, **lists)

        def plain(lv, xr=xr):
            return ab.whdia_hack_ablation_plain(lv, *args, xr, **static, **lists)
        kernels = {lv: (lambda lv=lv: kernel(lv)) for lv in ab.HACK_LEVELS}
        plains = {lv: (lambda lv=lv: plain(lv)) for lv in ab.HACK_LEVELS}
        before = ab.LAUNCHES_WHDIA_ABLATION
        outs = {lv: fn() for lv, fn in kernels.items()}
        launches += ab.LAUNCHES_WHDIA_ABLATION - before
        errs = {lv: check_close(outs[lv], plains[lv](), *tol,
                                f"#18 hack {lv} x{n_rhs} vs plain")
                for lv, tol in (("launch", (0, 0)), ("list", (0, 0)),
                                ("stream", (0, 1e-5)), ("full", (1e-5, 1e-5)))}
        production = (kd.whdia_spmv if n_rhs == 1 else kd.whdia_spmm)(
            *args, xr, **static, **lists)
        # on the card the same launch; on the CPU the full plain product
        err_prod = max(err_prod, check_close(
            outs["full"], production, 1e-5, 1e-5, f"#18 hack full x{n_rhs} vs "
            "the production launch"))
        if dev.type == "cuda" and not torch.equal(outs["full"], production):
            raise AssertionError(f"#18 hack full x{n_rhs} is not the production "
                                 "launch, bit for bit")
        out_bytes = n_rhs * hacks * 128 * 4
        moved = {"launch": head + out_bytes,
                 "list": head + chain + out_bytes,
                 "stream": head + chain + n_live * 512 + out_bytes,
                 "full": head + chain + n_live * 512 + out_bytes
                 + n_rhs * 4 * coo.n_cols}
        times = c.time_calls(dev, kernels, HACK_KERNELS[n_rhs], plains,
                             lambda xr=xr: c.csr_call(coo, xr if n_rhs == 1 else xr.T))
        group = [dict(level=lv, n_rhs=n_rhs, adds=ab.LEVEL_ADDS["whdia_hack"][lv],
                      output=f"z ({n_rhs}, num_groups*group_hacks*128)",
                      output_bytes=out_bytes, level_bytes=moved[lv],
                      level_bound_ms=1e3 * moved[lv] / HBM_BYTES_PER_S,
                      max_abs_err=errs[lv], **times[lv],
                      **c.rates(times[lv]["device_ms"], coo.nnz * n_rhs, a.num_tiles))
                 for lv in ab.HACK_LEVELS]
        c.add_prices(group)
        rows += group
        bounds[n_rhs] = bound(moved["full"], 2 * coo.nnz * n_rhs, "float32")
        library[n_rhs] = times["library"]
    return rows, launches, err_prod, dict(
        full_vs_production="the full levels against whdia_spmv (#3) and "
                           "whdia_spmm (#13), bit for bit on the card",
        live_slot_share=n_live / a.total_slots,
        bound_of="#3 whdia_spmv on the fixture, over the live slots",
        bound=bounds[1], bound_spmm=bounds[SPMM_RHS],
        library_call="torch.sparse_csr_tensor @ x (cuSPARSE CSR), float32; "
                     f"@ X.T (SpMM) at {SPMM_RHS} RHS",
        library=library[1], library_spmm=library[SPMM_RHS])


def print_result(res: dict) -> None:
    c.print_result(res, f"{res['matrix']} {res['rows']} ({res['family']} levels): "
                        f"tiles={res['tiles']} gh={res['group_hacks']} "
                        f"ct={res['chunk_tiles']} wp={res['window_pages']} "
                        f"pad={res['padding']:.2f} launches={res['launches']} "
                        f"on {res['device']}",
                   lambda r: f"{r['level']:8s}" + (f" x{r['n_rhs']}" if "n_rhs" in r
                                                   else ""))


def main() -> dict:
    return c.cli(run, __doc__, print_result,
                 options={"matrix": tuple(MATRICES), "family": FAMILIES})


if __name__ == "__main__":
    main()
