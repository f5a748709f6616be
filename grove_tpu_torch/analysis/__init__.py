"""grovelint over the port: static analysis and the runtime sanitizer.

Counterpart of ``grove_tpu/analysis``, in its two halves:

- **Static analyzer** (``engine.py`` + ``rules/``): the AST rule engine
  GL001–GL022 over every ``.py`` under ``grove_tpu_torch/`` (virtual clock,
  broker grants, the ``schedulable`` mask, the store's write path, torch
  hygiene in the device regions (GL005), registered event reasons, closed
  spans, lock order, wire-decodable types, and the state-privacy rules).
  ``python scripts/torch_lint.py`` runs it with the drift checks.
- **Runtime sanitizer** (``sanitize.py``, ``GROVE_TPU_SANITIZE=1``):
  dynamic checks of the invariants a static analysis cannot prove
  (lock-acquisition order, the store's byte-compare write guard,
  accountant-against-recount drift, leaked spans and stranded holds at
  harness teardown).

Stdlib-only at import time (ast/re/json/threading): linting imports no
torch, and the observability singletons and the store import the
sanitizer without cycles.
"""

from grove_tpu_torch.analysis.engine import (  # noqa: F401
    LintReport,
    Rule,
    Violation,
    lint_paths,
    lint_source,
    run_repo_lint,
)
