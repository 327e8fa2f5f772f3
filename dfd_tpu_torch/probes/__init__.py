"""Hopper probes: the questions of the TPU probes under ``tools/``, asked on the card.

Each module is the counterpart of a ``tools/probe_pallas_*.py`` with the same
cases, sizes and numpy ``RandomState`` inputs, run through the port's CUDA
kernels:

- :mod:`.gemm` (``probe_pallas_gemm.py``): what a matrix product costs inside
  a chain of them in one kernel, fixed against proportional cost;
- :mod:`.torso` (``probe_pallas_torso.py``): the relayouts a fused IMPALA
  torso needs (rolls, strided slices, a reshape copy, a row concat) and
  small conv-shaped product chains in both orientations;
- :mod:`.pool` (``probe_pallas_pool.py``): the candidates for the stride-2
  pool subsample, and the fused residual-conv chain at 16 channels in both
  layouts against the lowered (patches + matmul) chain;
- :mod:`.wide` (``probe_pallas_wide.py``): the same chain at production
  widths, 16, 64 and 128 channels, both layouts, f32 and bf16 operands.

Each exposes ``run(device=None, **sizes) -> list[dict]``, one row per case:
the kernel's time (CUDA events, after a warm call), its plain version's, the
PyTorch library route's where there is one, the bound, the match error and
the kernel launches the case made; and ``main()`` to print them
(``python -m dfd_tpu_torch.probes.wide [P]``).  A TPU probe caught each
case's failure, since whether Mosaic could lower it was its question; these
raise instead: a case that fails to build, launch or match its plain version
stops the probe.
"""
