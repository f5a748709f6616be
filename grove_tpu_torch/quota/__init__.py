"""Multi-tenant quota and fair-share queueing: the port of ``grove_tpu/quota``.

- ``accountant``: per-queue usage folded from pod watch events.
- ``ordering``: the DRF fair-share order, a hand-written CUDA scan
  (``csrc/drf.cu``) with its plain PyTorch twin.
- ``oracle``: the plain-numpy reference the ordering is held against.
- ``manager``: ceiling holds, the ordering pass and per-queue rows for the
  scheduler.
"""
