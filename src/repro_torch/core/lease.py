"""Leases: the unit of decentralized resource allocation (paper §3.2).

A client leases {workers, memory, timeout} directly from an executor
manager; the resource manager is NOT involved in the allocation path.
Lease lifetime is metered in GB-seconds for accounting (§5.4).  All
timestamps come from the lease's ``Clock`` (real by default, virtual
under simulation) so expiry and metering are exact and testable without
sleeping.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from repro_torch.core.clock import Clock, REAL_CLOCK

_lease_ids = itertools.count(1)


class LeaseState(Enum):
    PENDING = "pending"
    ACTIVE = "active"
    EXPIRED = "expired"          # timeout elapsed
    RELEASED = "released"        # client deallocated
    RETRIEVED = "retrieved"      # batch system took the node back
    FAILED = "failed"            # executor crash / node loss


#: States a lease can never leave (the state machine's sinks).
TERMINAL_STATES = frozenset({LeaseState.EXPIRED, LeaseState.RELEASED,
                             LeaseState.RETRIEVED, LeaseState.FAILED})

#: Priority lease classes (DESIGN.md §18), most- to least-protected:
#: under batch-system pressure spot-hosting nodes are reclaimed first
#: and premium-hosting nodes last; pricing scales the same way
#: (``accounting.CLASS_PRICE_FACTOR``).
LEASE_CLASSES = ("premium", "standard", "spot")

#: Preemption rank: higher = reclaimed later.  Spot leases are the
#: batch system's first target; premium leases are shielded until no
#: spot/standard capacity remains.
CLASS_PROTECTION = {"spot": 0, "standard": 1, "premium": 2}


@dataclass
class LeaseRequest:
    client_id: str
    n_workers: int
    memory_bytes: int
    timeout_s: float
    sandbox: str = "bare"        # bare | docker
    lease_class: str = "standard"  # premium | standard | spot (§18)

    def __post_init__(self):
        if self.lease_class not in CLASS_PROTECTION:
            raise ValueError(
                f"unknown lease class {self.lease_class!r}; expected "
                f"one of {LEASE_CLASSES}")


@dataclass
class Lease:
    request: LeaseRequest
    server_id: str
    # global counter default is for ad-hoc construction only; managers
    # pass explicit per-manager ids so seeded replays are bit-identical
    lease_id: int = field(default_factory=lambda: next(_lease_ids))
    state: LeaseState = LeaseState.PENDING
    t_granted: Optional[float] = None    # None until activated (a
    #                                      VirtualClock can start at 0.0)
    t_ended: Optional[float] = None
    clock: Clock = field(default=REAL_CLOCK, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def activate(self, now: Optional[float] = None):
        with self._lock:
            if self.state != LeaseState.PENDING:
                return     # terminal states are sinks; re-activation of
                # an ACTIVE lease must not reset the allocation meter
            self.state = LeaseState.ACTIVE
            self.t_granted = self.clock.now() if now is None else now

    def end(self, state: LeaseState, now: Optional[float] = None):
        with self._lock:
            if self.state == LeaseState.ACTIVE:
                self.state = state
                self.t_ended = self.clock.now() if now is None else now

    @property
    def alive(self) -> bool:
        return self.state == LeaseState.ACTIVE

    def expired(self, now: Optional[float] = None) -> bool:
        if self.t_granted is None:
            return False
        now = self.clock.now() if now is None else now
        return (self.state == LeaseState.ACTIVE
                and now - self.t_granted > self.request.timeout_s)

    def gb_seconds(self, now: Optional[float] = None) -> float:
        """Allocation meter t_a: GB of leased memory x seconds held."""
        if self.t_granted is None:
            return 0.0
        end = self.t_ended
        if end is None:
            end = self.clock.now() if now is None else now
        dur = max(0.0, end - self.t_granted)
        return (self.request.memory_bytes / 1e9) * dur
