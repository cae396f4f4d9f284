"""Accounting: C = C_a·t_a + C_c·t_c (paper §5.4).

t_a — GB-seconds of lease allocation; t_c — seconds of active compute.
The paper accumulates via RDMA atomic fetch-and-add on manager-exposed
memory regions, off the invocation critical path; the in-process analogue
is a lock-free-ish counter (GIL-atomic float adds batched at 1 s
granularity) that executors flush *after* completing invocations, never
inside the dispatch path.

Multi-tenant extensions (DESIGN.md §18): per-class pricing (premium
tenants pay for guaranteed capacity, spot tenants ride preemptible
idle nodes at a deep discount) and per-tenant lease-quota state — the
ledger is the one shared-everywhere object, so quota admission lives
here and every executor manager consults the same counters.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

GRANULARITY_S = 1.0                  # paper: one-second accumulation

#: Price multipliers by lease class (§5.4 + §6): premium buys
#: preemption protection and weighted bandwidth at a markup; spot is
#: the first capacity reclaimed under batch pressure and is priced
#: accordingly.  Standard is the 1.0 anchor so existing single-class
#: scenarios bill identically.
CLASS_PRICE_FACTOR = {"premium": 2.0, "standard": 1.0, "spot": 0.25}


@dataclass
class Price:
    c_a: float = 2.9e-6              # $ per GB-second of allocation
    c_c: float = 4.0e-5              # $ per second of active compute

    # HPC discount: idle resources offered below cloud rates (paper §5.4)
    def discounted(self, factor: float = 0.25) -> "Price":
        return Price(self.c_a * factor, self.c_c * factor)

    def for_class(self, lease_class: str) -> "Price":
        """Class-dependent price: the same rate card scaled by the
        lease class's multiplier (premium 2x, spot 0.25x)."""
        try:
            factor = CLASS_PRICE_FACTOR[lease_class]
        except KeyError:
            raise ValueError(
                f"unknown lease class {lease_class!r}; expected one of "
                f"{tuple(CLASS_PRICE_FACTOR)}") from None
        return Price(self.c_a * factor, self.c_c * factor)


@dataclass
class ClientBill:
    gb_seconds: float = 0.0          # t_a
    compute_seconds: float = 0.0     # t_c
    invocations: int = 0

    def cost(self, price: Price) -> float:
        return price.c_a * self.gb_seconds + price.c_c * self.compute_seconds


@dataclass
class QuotaState:
    """Per-tenant lease-quota counters: ``max_workers`` is the
    admission ceiling (None = unlimited), ``held_workers`` the live
    count across every manager, ``rejections`` how many negotiation
    attempts the quota refused (the lease-hoarding defense, §18)."""

    max_workers: Optional[int] = None
    held_workers: int = 0
    rejections: int = 0


class Ledger:
    """Global database associated with the resource manager (paper §5.4)."""

    def __init__(self, price: Price = Price()):
        self.price = price
        self._bills: Dict[str, ClientBill] = defaultdict(ClientBill)
        self._pending_compute: Dict[str, float] = defaultdict(float)
        self._quotas: Dict[str, QuotaState] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _check_id(client_id: str):
        # "" is a real key distinct from None in flush(); refusing it
        # at the charge sites keeps the falsy-id ambiguity out of the
        # ledger entirely
        if not isinstance(client_id, str) or not client_id:
            raise ValueError(
                f"client_id must be a non-empty string, got {client_id!r}")

    # executor-manager side (atomic fetch-and-add analogue) --------------
    def add_compute(self, client_id: str, seconds: float, *,
                    count: int = 1):
        """Batched at GRANULARITY_S so abrupt executor termination loses
        at most one granule (paper §5.4).  ``count`` is how many
        completed invocations this charge represents — a crash-retried
        invocation bills its wasted compute with ``count=0`` so the
        eventual successful retry is the only one counted."""
        self._check_id(client_id)
        with self._lock:
            self._pending_compute[client_id] += seconds
            self._bills[client_id].invocations += count
            if self._pending_compute[client_id] >= GRANULARITY_S:
                self._flush_locked(client_id)

    def add_compute_bulk(self, client_id: str, seconds: float, n: int):
        """Fold ``n`` completed invocations totalling ``seconds`` of
        compute in one locked update — the cohort fast path bills a
        whole fault-free window at once instead of paying a lock
        round-trip per invocation.  Granule semantics match ``n``
        individual ``add_compute`` calls: at most one granule of
        pending compute is ever at risk."""
        self._check_id(client_id)
        with self._lock:
            self._pending_compute[client_id] += seconds
            self._bills[client_id].invocations += n
            if self._pending_compute[client_id] >= GRANULARITY_S:
                self._flush_locked(client_id)

    def add_allocation(self, client_id: str, gb_seconds: float):
        self._check_id(client_id)
        with self._lock:
            self._bills[client_id].gb_seconds += gb_seconds

    def flush(self, client_id: str = None):
        with self._lock:
            # `is not None`: a falsy-but-real id ("" predates the
            # _check_id guard) must flush ONE tenant, not every tenant
            keys = ([client_id] if client_id is not None
                    else list(self._pending_compute))
            for k in keys:
                self._flush_locked(k)

    def _flush_locked(self, client_id: str):
        pend = self._pending_compute.pop(client_id, 0.0)
        self._bills[client_id].compute_seconds += pend

    # quota admission (DESIGN.md §18) -------------------------------------
    def set_quota(self, client_id: str, max_workers: Optional[int]):
        """Cap a tenant's concurrently-held workers across all
        managers; ``None`` removes the cap (held counts persist)."""
        self._check_id(client_id)
        if max_workers is not None and max_workers < 0:
            raise ValueError(f"max_workers must be >= 0, got {max_workers}")
        with self._lock:
            self._quotas.setdefault(
                client_id, QuotaState()).max_workers = max_workers

    def try_acquire_workers(self, client_id: str, n: int) -> bool:
        """Admission check at lease negotiation: atomically charge
        ``n`` workers against the tenant's quota.  False (and a
        recorded rejection) when the grant would exceed the cap."""
        self._check_id(client_id)
        with self._lock:
            q = self._quotas.get(client_id)
            if q is None:
                q = self._quotas[client_id] = QuotaState()
            if (q.max_workers is not None
                    and q.held_workers + n > q.max_workers):
                q.rejections += 1
                return False
            q.held_workers += n
            return True

    def release_workers(self, client_id: str, n: int):
        """Return ``n`` workers to the tenant's quota (lease released,
        retrieved, expired or failed)."""
        self._check_id(client_id)
        with self._lock:
            q = self._quotas.get(client_id)
            if q is not None:
                q.held_workers = max(0, q.held_workers - n)

    def quota(self, client_id: str) -> QuotaState:
        self._check_id(client_id)
        with self._lock:
            q = self._quotas.get(client_id, QuotaState())
            return QuotaState(q.max_workers, q.held_workers, q.rejections)

    def quota_rejections(self) -> int:
        with self._lock:
            return sum(q.rejections for q in self._quotas.values())

    def held_workers(self) -> Dict[str, int]:
        """Snapshot of every tenant's live held-worker count — the
        chaos invariant surface (DESIGN.md §20): after a drained
        scenario every entry must be back to zero, or a lease ended
        without returning its quota (an orphaned ``QuotaState``)."""
        with self._lock:
            return {cid: q.held_workers
                    for cid, q in self._quotas.items()}

    # client/operator side ------------------------------------------------
    def bill(self, client_id: str) -> ClientBill:
        self.flush(client_id)
        with self._lock:
            b = self._bills[client_id]
            return ClientBill(b.gb_seconds, b.compute_seconds,
                              b.invocations)

    def cost(self, client_id: str, lease_class: str = "standard") -> float:
        return self.bill(client_id).cost(self.price.for_class(lease_class))

    def totals(self) -> ClientBill:
        self.flush()
        with self._lock:
            t = ClientBill()
            for b in self._bills.values():
                t.gb_seconds += b.gb_seconds
                t.compute_seconds += b.compute_seconds
                t.invocations += b.invocations
            return t
