"""The per-op cycle accounts and the geometry sweep on the card: the port
of the JAX package's ``doc/sweeps/``.

* :mod:`~spgpu_tpu_torch.sweeps.whdia_ablation` — kernel #18: the WHDIA
  SpMV (#3) in pattern mode, fp32, on banded-11, one op family at a time;
* :mod:`~spgpu_tpu_torch.sweeps.dd_ablation` — kernel #19: the float64
  packed WHELL SpMV (#4) on the 512x512 Laplacian, one op family at a
  time;
* :mod:`~spgpu_tpu_torch.sweeps.dd_geom_sweep` — #4 on the same
  Laplacian at six ``(group_hacks, chunk_tiles)`` geometries.

Each has ``run(device, *, size=...)``, which returns its rows, and
``main()``, which runs it at the JAX script's size::

    python -m spgpu_tpu_torch.sweeps.<name> [--device cpu]

The device is ``cuda`` unless the caller asks for the CPU; without a card
``cuda`` raises.  On the card every level is held against its plain
version and timed: warm and cold device time of the level's own kernels
(:func:`~spgpu_tpu_torch.utils.timing.kernel_device_ms`), per-call time
from CUDA events, and the price of each op family (the difference from
the level before, where both times have one source).  On the CPU the levels run their plain versions, are
checked, and every time is None (``timing`` says so).
"""
