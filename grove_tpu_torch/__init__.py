"""PyTorch + CUDA port of grove-tpu's gang-admission solver (Hopper / H100).

Mirrors ``grove_tpu``'s module paths so each counterpart is easy to find,
and imports nothing from ``grove_tpu`` or ``jax``: what it needs from the
JAX package it keeps as its own copy. Ported so far: the gRPC sidecar's
solve path — decoded request → ``solver.encode.build_problem`` →
``solver.kernel.solve_waves`` (host wave loop) → ``ops.packing``
(``solve_wave_chunk`` / ``wave_chunk_core`` / ``gang_select_single``) →
``ops.fill.fill_batch``, whose CUDA tensors run the hand-written Hopper
kernel in ``csrc/fill.cu``; the stats path and the exact solve; and the
scheduler round, ``solver.scheduler.GangScheduler`` over the port's own
store (``runtime.store``), whose DRF fair-share order
(``quota.ordering.fair_order``) runs the hand-written kernel in
``csrc/drf.cu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no card present they raise (never a silent CPU
fallback). On the CPU every kernel wrapper runs its plain PyTorch version.
"""
