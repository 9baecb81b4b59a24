"""Device microseconds an iteration spends in NCCL's kernels on rank 0
(``parallel/``: the halo exchange's ``batch_isend_irecv`` and the inner
products' ``all_reduce``), from the traced slice, over the iterations its
solves reported."""


def read(rec: dict):
    sl = rec.get("slice")
    if not sl or not rec.get("slice_iterations"):
        return None
    t0, t1 = sl["t0"], sl["t1"]
    nccl = [min(b, t1) - max(a, t0) for n, a, b in sl["device_ops"]
            if n.startswith("ncclDevKernel") and b > t0 and a < t1]
    return 1e6 * sum(nccl) / rec["slice_iterations"] if nccl else None
