"""The distributed layer's dry run: the port's counterpart of
``dryrun_multichip`` (``__graft_entry__.py:43-118``).

    python -m spgpu_tpu_torch.parallel.dryrun --ranks N [--device cuda|cpu]

starts ``N`` ranks (:func:`~spgpu_tpu_torch.parallel.group.run_ranks`:
NCCL with one card a rank by default, raising without a card; gloo on
the CPU with ``--device cpu``) and holds each
result to the host golden (``CooMatrix.spmv`` in float64 or complex128):
the packed fp32 partition's SpMV and CG, float64 CG, a complex64
Hermitian system's SpMV and CG, the solve handle's two solves on one
placement, the classic partition's SpMV and CG, and the JAX dry run's
third leg, the HELL partition (``partition_coo_rows``, plain torch
products) in fp32.  It prints one JSON line per case and exits non-zero
if a case fails.

:func:`run_cases` is the rank side, also for the tests: it runs a list of
distributed calls on one rank and returns their results as NumPy.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["dryrun", "run_cases"]


def run_cases(rg, cases) -> list:
    """Run ``cases`` on this rank, in order; each is ``(op, partition,
    kw)``: ``"spmv"`` (``kw``: ``x``) gives the global product,
    ``"cg"``/``"bicgstab"`` (``kw``: ``b`` and the solve's keywords) a
    dict of ``x``, ``iterations``, ``residual_norm``, ``converged`` and
    ``launches`` (the kernel launch counters that moved, ``"module.NAME":
    count``), and ``"handle"`` (``kw``: ``bs``, a list of right-hand
    sides, and the solve's keywords) those of each solve of one
    :class:`~spgpu_tpu_torch.parallel.dist_solve.DistSolveHandle` and its
    ``placements``."""
    from spgpu_tpu_torch import kernels
    from spgpu_tpu_torch.parallel.dist_solve import DistSolveHandle
    from spgpu_tpu_torch.parallel.dist_spmv import dist_spmv

    def solved(solve):
        before = kernels.launch_counts()
        r = solve()
        return dict(x=r.x.cpu().numpy(), iterations=int(r.iterations),
                    residual_norm=float(r.residual_norm),
                    converged=bool(r.converged), launches={
                        f"{m.__name__.rsplit('.', 1)[-1]}.{name}": n for (m, name), n
                        in kernels.launch_counts_since(before).items()})

    out = []
    for op, pm, kw in cases:
        kw = dict(kw)
        if op == "spmv":
            out.append(dist_spmv(pm, kw["x"], rg).cpu().numpy())
        elif op in ("cg", "bicgstab"):
            b = kw.pop("b")
            h = DistSolveHandle(pm, rg)
            out.append(solved(lambda: h.solve(b, symmetric=op == "cg", **kw)))
        elif op == "handle":
            h = DistSolveHandle(pm, rg)
            res = [solved(lambda b=b: h.solve(b, **kw)) for b in kw.pop("bs")]
            out.append(dict(solves=res, placements=h.placements))
        else:
            raise ValueError(f"unknown case {op!r}")
    return out


def _hermitian_tridiagonal(n: int, rng) -> "CooMatrix":  # noqa: F821
    """The JAX dry run's complex64 Hermitian PD system: 4 on the
    diagonal, conjugate off-diagonal pairs of size ~0.3."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    r = np.arange(n)
    off = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.3
    return CooMatrix(np.concatenate([r, r[:-1], r[1:]]),
                     np.concatenate([r, r[1:], r[:-1]]),
                     np.concatenate([np.full(n, 4.0 + 0j), off, np.conj(off)]
                                    ).astype(np.complex64), n, n)


def dryrun(n_ranks: int, device: str = "cuda") -> list:
    """The dry run on ``n_ranks`` ranks, on the cards unless ``device`` is
    ``"cpu"``; returns one record per case, each with its error against
    the golden and whether it passed."""
    from spgpu_tpu_torch.parallel.group import run_ranks
    from spgpu_tpu_torch.parallel.partition import partition_coo_rows
    from spgpu_tpu_torch.parallel.partition_packed import partition_coo_rows_packed
    from spgpu_tpu_torch.parallel.partition_whell import partition_coo_rows_whell
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d

    rng = np.random.default_rng(0)
    coo = laplacian_2d(24, n_ranks * 8, dtype=np.float32)
    n = coo.n_rows
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    b2 = rng.standard_normal(n).astype(np.float32)
    coo64 = laplacian_2d(24, n_ranks * 8, dtype=np.float64)
    b64 = rng.standard_normal(n)
    cooc = _hermitian_tridiagonal(n, rng)
    xc = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    bc = cooc.spmv(xc).astype(np.complex64)
    packed = partition_coo_rows_packed(coo, n_ranks)
    classic = partition_coo_rows_whell(coo, n_ranks)
    hell = partition_coo_rows(coo, n_ranks)
    pmc = partition_coo_rows_packed(cooc, n_ranks)
    cg = dict(tol=1e-5, maxiter=400)
    cases = [
        ("packed fp32 spmv", "spmv", packed, dict(x=x), coo, x, 1e-4),
        ("packed fp32 cg", "cg", packed, dict(b=b, **cg), coo, b, 1e-3),
        ("packed float64 cg", "cg", partition_coo_rows_packed(coo64, n_ranks),
         dict(b=b64, tol=1e-10, maxiter=800), coo64, b64, 1e-8),
        ("packed complex64 spmv", "spmv", pmc, dict(x=xc), cooc, xc, 1e-4),
        ("packed complex64 hermitian cg", "cg", pmc, dict(b=bc, **cg), cooc, bc, 1e-3),
        ("packed fp32 handle, two solves", "handle", packed, dict(bs=[b, b2], **cg),
         coo, None, 1e-3),
        ("classic fp32 spmv", "spmv", classic, dict(x=x), coo, x, 1e-4),
        ("classic fp32 cg", "cg", classic, dict(b=b, **cg), coo, b, 1e-3),
        ("HELL fp32 spmv", "spmv", hell, dict(x=x), coo, x, 1e-4),
        ("HELL fp32 cg", "cg", hell, dict(b=b, **cg), coo, b, 1e-3)]
    got = run_ranks(n_ranks, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                    [c[1:4] for c in cases], device=device)
    out = []
    for i, (name, op, _, kw, a, v, tol) in enumerate(cases):
        res = got[0][i]
        rec = dict(case=name, ranks=n_ranks, device=device)
        if op == "spmv":
            g = a.spmv(v.astype(np.complex128 if np.iscomplexobj(v) else np.float64))
            rec["err"] = float(np.abs(res - g).max() / np.abs(g).max())
        else:
            solves = res["solves"] if op == "handle" else [res]
            bs = kw["bs"] if op == "handle" else [v]
            rec["err"] = max(float(np.linalg.norm(bb - a.spmv(s["x"])) / np.linalg.norm(bb))
                             for bb, s in zip(bs, solves))
            rec["iterations"] = [s["iterations"] for s in solves]
            if op == "handle":
                rec["placements"] = res["placements"]
        same = all(_equal(got[r][i], res) for r in range(1, n_ranks))
        rec["ranks_agree"] = same
        rec["ok"] = bool(rec["err"] < tol and same and rec.get("placements", 1) == 1)
        out.append(rec)
    return out


#: what a rank reports of itself alone, not held equal across ranks: its
#: kernels' launches (a shard with no halo launches no exterior product)
_PER_RANK = ("launches",)


def _equal(a, b) -> bool:
    """Whether two ranks' results of a case agree, bit for bit, in all
    but :data:`_PER_RANK`."""
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a if k not in _PER_RANK)
    if isinstance(a, list):
        return all(_equal(u, v) for u, v in zip(a, b))
    return bool(np.array_equal(a, b))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    recs = dryrun(args.ranks, args.device)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
