"""Lease-based leader election over the apiserver.

Counterpart of ``grove_tpu/cluster/lease.py``, with the same names, wire
format and status codes.

The reference elects through a coordination.k8s.io/v1 Lease on the
kube-apiserver (manager.go:84-98: LeaderElection + LeaderElectionID +
LeaderElectionReleaseOnCancel). This is the same protocol against our own
apiserver: a Lease object holds (holderIdentity, renewTime,
leaseDurationSeconds, leaseTransitions); candidates race CREATE, the holder
renews every retry period, standbys take over once the holder's renewTime
stops changing for a lease duration, and graceful shutdown clears the
holder so failover is immediate. The store's optimistic concurrency
(resourceVersion conflict on update) is what makes the race safe across
processes — exactly the role the kube apiserver plays for client-go's
leaderelection package.

client-go semantics deliberately preserved:
  - **Skew immunity**: a standby never compares the lease's renewTime
    timestamp against its own wall clock (cross-host clock skew would steal
    live leases). It records WHEN IT LOCALLY OBSERVED the renewTime value
    change and declares expiry only after a full lease duration of local
    monotonic time without a change.
  - **Renew-deadline tolerance**: transient apiserver/transport failures
    during renew do not drop leadership; the leader steps down only after
    failing to renew for `renew_deadline` seconds (then standbys are about
    to take over anyway).
  - **Background renewal**: with `background_renew=True` (the operator run
    loop's mode) a daemon thread renews every `retry_period`, decoupled
    from reconcile-round length — a long converge round can't silently let
    the lease lapse mid-round.
  - No campaign/renew error ever propagates: election is infrastructure
    upkeep; the run loop must survive apiserver restarts.

Unlike the FileLeaderLock (single shared filesystem), this works for any
set of operator hosts that can reach the apiserver — the HA deployment
shape of the reference.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid
from typing import Optional

from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import GenericObject
from grove_tpu_torch.runtime.errors import ERR_CONFLICT, ERR_NOT_FOUND, GroveError


def default_identity() -> str:
    """hostname_pid_nonce — unique per elector (client-go uses
    hostname + '_' + uuid; the nonce also separates two runtimes that
    share a process, as in-process HA tests do)."""
    return f"{socket.gethostname()}_{os.getpid()}_{uuid.uuid4().hex[:6]}"


class LeaseElector:
    """Campaign for, renew, and release one named Lease.

    Protocol:
      - `try_acquire`: create the Lease if absent; adopt it if released or
        locally-observed-expired; renew it if already ours. Returns False
        on any race lost or infrastructure error (campaign again next
        tick).
      - `renew`: heartbeat. Returns False when leadership was LOST —
        the caller must stop acting as leader immediately. Transient
        errors inside `renew_deadline` keep leadership.
      - `release`: clear holderIdentity (keep the object + transitions
        counter) so standbys take over without waiting out the duration.
      - `stop_renewing`: halt the background renewer WITHOUT releasing —
        the crash simulation (and the pre-release step of shutdown).
    """

    def __init__(
        self,
        store,
        name: str = "grove-tpu-leader-election",
        namespace: str = "default",
        identity: Optional[str] = None,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        background_renew: bool = False,
    ) -> None:
        self.store = store
        self.name = name
        self.namespace = namespace
        self.identity = identity or default_identity()
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.background_renew = background_renew
        self.is_leader = False
        # local observation of the current holder's renew progress:
        # (holder, renewTime value, monotonic timestamp of first sighting)
        self._observed: Optional[tuple] = None
        self._last_renew_ok: float = 0.0  # monotonic
        self._renew_stop: Optional[threading.Event] = None

    # -- wire object ------------------------------------------------------

    def _get(self):
        return self.store.get("Lease", self.namespace, self.name)

    def _spec(self, acquire_time: float, transitions: int) -> dict:
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": self.lease_duration,
            "acquireTime": acquire_time,
            "renewTime": time.time(),
            "leaseTransitions": transitions,
        }

    def _won(self) -> bool:
        self.is_leader = True
        self._last_renew_ok = time.monotonic()
        if self.background_renew:
            self._start_renewer()
        return True

    # -- campaign ---------------------------------------------------------

    def _foreign_lease_expired(self, holder: str, renew_time: float) -> bool:
        """Skew-immune expiry: true only after a full lease duration of
        LOCAL monotonic time without observing renewTime change."""
        now = time.monotonic()
        if self._observed is None or self._observed[:2] != (holder, renew_time):
            self._observed = (holder, renew_time, now)
            return False
        return now - self._observed[2] >= self.lease_duration

    def try_acquire(self) -> bool:
        try:
            return self._try_acquire()
        except GroveError:
            return False  # apiserver blip: campaign again next tick

    def _try_acquire(self) -> bool:
        lease = self._get()
        if lease is None:
            obj = GenericObject(
                kind="Lease",
                metadata=ObjectMeta(name=self.name, namespace=self.namespace),
                spec=self._spec(acquire_time=time.time(), transitions=0),
            )
            try:
                self.store.create(obj)
            except GroveError as exc:
                if exc.code == ERR_CONFLICT:
                    return False  # lost the create race
                raise
            return self._won()
        holder = lease.spec.get("holderIdentity") or ""
        renew_time = float(lease.spec.get("renewTime") or 0.0)
        if holder == self.identity:
            # re-adopting our own lease (e.g. apiserver outage outlasted the
            # renew deadline, then recovered before anyone stole it) —
            # _won() must run so the background renewer RESTARTS; renew()
            # alone would leave is_leader=True with nothing renewing
            self.is_leader = True
            return self._won() if self.renew() else False
        if holder and not self._foreign_lease_expired(holder, renew_time):
            return False  # live leader elsewhere
        # released or expired: take over, bumping the transitions counter
        lease.spec = self._spec(
            acquire_time=time.time(),
            transitions=int(lease.spec.get("leaseTransitions") or 0) + 1,
        )
        try:
            self.store.update(lease, bump_generation=False)
        except GroveError as exc:
            if exc.code in (ERR_CONFLICT, ERR_NOT_FOUND):
                return False  # another standby won the takeover
            raise
        return self._won()

    def acquire_blocking(self, stop=None, on_wait=None) -> bool:
        """Standby loop: campaign every retry_period until leadership or
        `stop`; `on_wait` runs between attempts (e.g. dropping queued watch
        events nobody will drain). Returns False only when stopped."""
        while stop is None or not stop.is_set():
            if self.try_acquire():
                return True
            if on_wait is not None:
                on_wait()
            if stop is None:
                time.sleep(self.retry_period)
            else:
                stop.wait(self.retry_period)
        return False

    # -- leadership upkeep ------------------------------------------------

    def renew(self) -> bool:
        """Heartbeat. False = leadership lost; stop leading NOW.
        Infrastructure errors are tolerated until renew_deadline."""
        if not self.is_leader:
            return False
        try:
            lease = self._get()
            if lease is None or lease.spec.get("holderIdentity") != self.identity:
                self._lost()
                return False
            lease.spec = dict(lease.spec, renewTime=time.time())
            self.store.update(lease, bump_generation=False)
            self._last_renew_ok = time.monotonic()
            return True
        except GroveError as exc:
            if exc.code in (ERR_CONFLICT, ERR_NOT_FOUND):
                # a conflict only means LOST if the holder changed — our own
                # concurrent renew (background thread + a manual call) also
                # conflicts, benignly
                try:
                    fresh = self._get()
                except GroveError:
                    fresh = None
                if (
                    fresh is not None
                    and fresh.spec.get("holderIdentity") == self.identity
                ):
                    self._last_renew_ok = time.monotonic()
                    return True
                self._lost()
                return False
            # transport/apiserver blip: keep leading inside the deadline
            if time.monotonic() - self._last_renew_ok > self.renew_deadline:
                self._lost()
                return False
            return True

    def _lost(self) -> None:
        self.is_leader = False
        self._observed = None
        self.stop_renewing()

    # -- background renewer -----------------------------------------------

    def _start_renewer(self) -> None:
        if self._renew_stop is not None and not self._renew_stop.is_set():
            return  # already running
        stop = threading.Event()
        self._renew_stop = stop

        def loop():
            while not stop.wait(self.retry_period):
                if not self.is_leader or not self.renew():
                    break

        threading.Thread(
            target=loop, name=f"lease-renew-{self.name}", daemon=True
        ).start()

    def stop_renewing(self) -> None:
        """Halt background renewal without touching the lease — from here
        the lease ages out like a crashed leader's would."""
        if self._renew_stop is not None:
            self._renew_stop.set()

    def release(self) -> None:
        """Graceful abdication (LeaderElectionReleaseOnCancel): clear the
        holder so the next campaign wins without waiting out the lease."""
        self.stop_renewing()
        if not self.is_leader:
            return
        self.is_leader = False
        self._observed = None
        try:
            lease = self._get()
            if lease is not None and lease.spec.get("holderIdentity") == self.identity:
                lease.spec = dict(lease.spec, holderIdentity="", renewTime=0.0)
                self.store.update(lease, bump_generation=False)
        except GroveError:
            pass  # releasing best-effort; expiry covers the crash path
