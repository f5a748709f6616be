"""Named-task runner with slow-start exponential batching.

Counterpart of ``grove_tpu/utils/concurrent.py``.

Re-host of reference operator/internal/utils/concurrent.go:69-90: burst
protection for the apiserver — tasks run in batches of 1, 2, 4, 8… so a
storm of failures is detected after a handful of calls instead of hundreds
(the k8s job-controller pattern). Panic (exception) recovery per task;
bounded parallelism via threads when requested (the sim store is
single-threaded, so the default is sequential batching with the same
semantics).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class Task:
    name: str
    fn: Callable[[], None]


@dataclass
class RunResult:
    completed: List[str] = field(default_factory=list)
    failed: List[Tuple[str, Exception]] = field(default_factory=list)

    @property
    def has_errors(self) -> bool:
        return bool(self.failed)

    def summary(self) -> str:
        return (
            f"{len(self.completed)} completed, {len(self.failed)} failed"
            + (
                ": " + "; ".join(f"{n}: {e}" for n, e in self.failed[:5])
                if self.failed
                else ""
            )
        )


def run_concurrently_with_slow_start(
    tasks: List[Task],
    initial_batch: int = 1,
    max_workers: Optional[int] = None,
) -> RunResult:
    """Run tasks in slow-start batches (1, 2, 4, …); any failure in a batch
    aborts the remaining batches (reference slowStartBatch semantics — stop
    sending bursts at an unhappy apiserver)."""
    result = RunResult()
    batch = max(initial_batch, 1)
    index = 0
    while index < len(tasks):
        chunk = tasks[index : index + batch]
        index += len(chunk)
        failures_before = len(result.failed)
        if max_workers and max_workers > 1 and len(chunk) > 1:
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                futures = [(t, pool.submit(t.fn)) for t in chunk]
                for task, fut in futures:
                    try:
                        fut.result()
                        result.completed.append(task.name)
                    except Exception as exc:  # noqa: BLE001 — per-task recovery
                        result.failed.append((task.name, exc))
        else:
            for task in chunk:
                try:
                    task.fn()
                    result.completed.append(task.name)
                except Exception as exc:  # noqa: BLE001 — per-task recovery
                    result.failed.append((task.name, exc))
        if len(result.failed) > failures_before:
            # slow-start abort: record the rest as skipped failures
            for task in tasks[index:]:
                result.failed.append(
                    (task.name, RuntimeError("skipped: slow-start aborted"))
                )
            break
        batch *= 2
    return result
