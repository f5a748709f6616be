"""Seeded fault injection for the worker-process wire boundary.

Counterpart of ``grove_tpu/runtime/boundary.py``.

The coordinator↔worker channel (runtime/procworkers.py) is JSON frames
over a pipe — reliable in-order bytes. Gray failures live one layer up:
a frame that never arrives (drop), arrives twice (duplicate), or
arrives late (delay). :class:`BoundaryFaults` is the seeded fault PLAN
for one run: a pure function of ``(seed, direction, worker, frame
seq)`` via the tree's crc32 draw idiom (no wall clock, no
unseeded RNG), so the coordinator and its forked children — each
holding a copy — compute identical verdicts without exchanging a byte.

The tolerance protocol the faults exercise (armed only — the unarmed
channel code is byte-identical to the fault-free build):

- every frame carries a monotone per-channel sequence number;
- receivers DEDUP on it: a frame at or below the high-water mark is a
  duplicate and is dropped (coordinator) or answered from the cached
  reply (worker — the idempotent-RPC shape: re-asking must not
  re-execute the batch);
- senders treat drop and delay as "the retry path delivers": the frame
  is withheld and the coordinator's retrying ``_recv`` retransmits the
  request after a :class:`BackoffPolicy` pace — a retransmitted request
  re-triggers the worker's cached-reply resend, healing a lost reply
  too. Retransmits bypass injection (one fault per frame seq — gray
  loss, not a dead link; the fail-closed ``BATCH_DEADLINE_S`` still
  bounds the whole exchange).
"""

from __future__ import annotations

import zlib

from grove_tpu_torch.runtime.backoff import BackoffPolicy

# retransmit pacing: base real-time pause before the first re-send of a
# withheld/lost frame, doubling per attempt under the shared policy (the
# third retry loop unified onto runtime/backoff.py)
RETRANSMIT_BASE_S = 0.2
RETRANSMIT_CAP_S = 2.0

OK = "ok"
DROP = "drop"
DUP = "dup"
DELAY = "delay"


class BoundaryFaults:
    """One run's seeded fault plan for the wire-codec boundary.

    Rates are cumulative probabilities over the uniform crc32 draw:
    ``u < drop_rate`` drops, then ``dup_rate`` duplicates, then
    ``delay_rate`` delays; the rest pass clean. Deterministic per
    (seed, direction, worker, seq) — a forked copy agrees with the
    original on every verdict.
    """

    def __init__(
        self,
        seed: int,
        drop_rate: float = 0.0,
        dup_rate: float = 0.0,
        delay_rate: float = 0.0,
    ) -> None:
        self.seed = seed
        self.drop_rate = drop_rate
        self.dup_rate = dup_rate
        self.delay_rate = delay_rate
        self.policy = BackoffPolicy(
            base=RETRANSMIT_BASE_S, cap=RETRANSMIT_CAP_S
        )

    def decide(self, direction: str, worker: int, seq: int) -> str:
        """Fault verdict for frame ``seq`` on ``direction`` ("c2w" or
        "w2c") of worker ``worker``'s channel."""
        u = (
            zlib.crc32(
                f"{self.seed}:{direction}:{worker}:{seq}".encode()
            )
            & 0xFFFF
        ) / float(1 << 16)
        if u < self.drop_rate:
            return DROP
        u -= self.drop_rate
        if u < self.dup_rate:
            return DUP
        u -= self.dup_rate
        if u < self.delay_rate:
            return DELAY
        return OK

    def retransmit_after(self, worker: int, attempt: int) -> float:
        """Real-time pause before retransmit ``attempt`` (0-based) on
        worker ``worker``'s channel."""
        return self.policy.delay(("bseq", worker), attempt)
