"""The runtime sanitizer (``sanitize.py``, ``GROVE_TPU_SANITIZE=1``).

Counterpart of the runtime half of ``grove_tpu/analysis``: dynamic checks
of the invariants a static analysis cannot prove (lock-acquisition order,
the store's byte-compare write guard, accountant-against-recount drift,
leaked spans and stranded holds at harness teardown). Stdlib-only at
import time, so the observability singletons and the store import it
without cycles.
"""
