"""Client library: decentralized allocation + low-latency invocation
(paper §3.2, §3.3, §5.1 programming model).

``Invoker`` is the C++-executor-concept-inspired client handle:

  * ``allocate(n_workers, ...)`` — reads a ranked server list from a
    random resource-manager REPLICA, walks a RANDOM PERMUTATION of it
    (each server asked at most once per round), negotiates leases
    directly with executor managers OVER CONTROL CHANNELS (transport
    fabric, DESIGN.md §12) — the connection-setup cost is paid once and
    the channel cached, making the paper's warm/hot connection reuse
    explicit — and retries rounds with exponential backoff.  Lost
    negotiation messages (injected drops, partitions) are absorbed by
    the same backoff loop.
  * ``submit(fn, payload)`` -> RFuture — round-robin over connected
    workers; each dispatch is a data-channel send whose modeled wire
    time lands on the invocation timeline.  On executor crash OR broken
    route the library retries the invocation on another worker/server
    up to ``max_retries`` (§3.5).
  * private executors (§3.5): a job-internal manager can be attached so
    offloading still works under public-resource starvation.
"""
from __future__ import annotations

import itertools
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import math

from repro_torch.core.clock import Clock, REAL_CLOCK
from repro_torch.core.executor import (AllocationRejected, ExecutorCrash,
                                 ExecutorManager, ExecutorProcess,
                                 ExecutorWorker)
from repro_torch.core.functions import FunctionLibrary
from repro_torch.core.invocation import Invocation, InvocationHeader, RFuture
from repro_torch.core.lease import LEASE_CLASSES, LeaseRequest
from repro_torch.core.resource_manager import ResourceManager
from repro_torch.core.transport import (Channel, ChannelDropped, ChannelError,
                                  ChannelPartitioned, CONTROL_MSG_BYTES,
                                  Fabric, WIRE_COUNTERS)

ALWAYS_WARM_INVOCATIONS = "always_warm"

#: Default network share weight per lease class (DESIGN.md §18): a
#: premium tenant's traffic takes twice the standard share of a
#: contended link, spot half.  Standard's exact 1.0 registers NOTHING
#: on the fabric, so classless scenarios keep the unweighted 1/K
#: arithmetic bit-identically.
CLASS_NET_WEIGHT = {"premium": 2.0, "standard": 1.0, "spot": 0.5}

#: SLO placement headroom per class: a premium allocation ranks
#: candidate servers whose heartbeat NIC-load snapshot is at/above
#: this many in-flight transfers BEHIND quieter same-group candidates;
#: standard/spot tolerate any load (inf -> the pre-QoS ordering).
CLASS_NIC_HEADROOM = {"premium": 4.0, "standard": math.inf,
                      "spot": math.inf}

_HDR_SIZE = InvocationHeader.SIZE        # hoisted off the dispatch loop


class AllocationFailed(RuntimeError):
    pass


@dataclass
class Connection:
    """Cached client<->executor-process channel (paper: RDMA connection
    per worker thread, cached across invocations)."""
    manager: ExecutorManager
    process: ExecutorProcess
    private: bool = False

    def alive(self) -> bool:
        return (self.manager.heartbeat() and self.process.lease.alive
                and bool(self.process.alive_workers()))


@dataclass
class InvokerStats:
    allocations_tried: int = 0
    allocations_granted: int = 0
    allocation_rounds: int = 0
    batch_rpcs: int = 0              # control rpcs spent in allocate_batch
    invocations: int = 0
    retries: int = 0
    failures: int = 0
    # transport-layer surface (DESIGN.md §12)
    connections_opened: int = 0      # control channels set up (cold)
    connections_reused: int = 0      # cached-channel allocations (warm)
    negotiation_faults: int = 0      # lease rpcs lost to drops/partitions
    dispatch_faults: int = 0         # data-channel sends that failed over


class Invoker:
    def __init__(self, client_id: str, rm: ResourceManager,
                 library: FunctionLibrary, *, seed: int = 0,
                 max_retries: int = 3, backoff_base: float = 0.005,
                 backoff_cap: float = 0.5, backoff_jitter: float = 0.0,
                 allocation_rounds: int = 6,
                 fault_memory_s: float = 1.0,
                 allocation_window: Optional[int] = None,
                 clock: Clock = REAL_CLOCK,
                 fabric: Optional[Fabric] = None,
                 lease_class: str = "standard",
                 net_weight: Optional[float] = None,
                 net_cap: Optional[float] = None,
                 nic_headroom: Optional[float] = None):
        if lease_class not in CLASS_NET_WEIGHT:
            raise ValueError(
                f"unknown lease class {lease_class!r}; expected one of "
                f"{LEASE_CLASSES}")
        self.client_id = client_id
        self.rm = rm
        self.library = library
        self.clock = clock
        # QoS surface (DESIGN.md §18): every lease this client
        # negotiates carries its class; the class also defaults the
        # tenant's network weight and placement headroom
        self.lease_class = lease_class
        self.nic_headroom = (CLASS_NIC_HEADROOM[lease_class]
                             if nic_headroom is None else nic_headroom)
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        if backoff_jitter < 0.0:
            raise ValueError(
                f"backoff_jitter must be >= 0, got {backoff_jitter}")
        self.backoff_jitter = backoff_jitter
        # dedicated jitter stream, derived from the client seed but
        # SEPARATE from the placement RNG: enabling jitter must not
        # perturb which servers this client walks (§3.2), and with
        # jitter off no draw is ever consumed — pre-jitter schedules
        # stay bit-identical
        self._backoff_rng = random.Random(
            (seed * 1_103_515_245 + 12_345) & 0x7FFFFFFF)
        self.allocation_rounds = allocation_rounds
        # fabric-aware placement: servers that faulted on this client
        # within fault_memory_s are tried LAST; allocation_window bounds
        # how many candidate servers one round considers on huge
        # clusters (cached-channel servers are always kept)
        self.fault_memory_s = fault_memory_s
        self.allocation_window = allocation_window
        # one fabric per cluster: default to the resource manager's so a
        # single partition() severs control and data plane together
        self.fabric = fabric if fabric is not None else rm.fabric
        self.endpoint = f"client:{client_id}"
        self._rng = random.Random(seed)
        self._replica = rm.replica_for(seed)
        self._conns: List[Connection] = []
        self._ctrl: Dict[str, Channel] = {}      # server_id -> control ch
        self._data: Dict[str, Channel] = {}      # worker name -> data ch
        # last validated (worker, connection) snapshot; None = dirty
        self._pairs_cache: Optional[List[Tuple[ExecutorWorker,
                                               Connection]]] = None
        self._fault_at: Dict[str, float] = {}    # server -> last fault t
        # counters of channels already closed, so transport_stats()
        # stays monotonic across failover/deallocate
        self._retired_wire = {key: 0 for key in WIRE_COUNTERS}
        self._rr = itertools.count()
        self._lock = threading.RLock()
        self.stats = InvokerStats()
        self._removed_servers: set = set()
        rm.bus.subscribe(self._on_delta, endpoint=self.endpoint)
        # register the tenant's network share on the fabric — ONLY when
        # it deviates from the unit weight, so standard tenants leave
        # the congestion arithmetic untouched
        weight = (CLASS_NET_WEIGHT[lease_class] if net_weight is None
                  else net_weight)
        if weight != 1.0 or net_cap is not None:
            self.fabric.set_tenant_qos(self.endpoint, weight=weight,
                                       cap=net_cap)

    # ------------------------------------------------------- notifications
    def _on_delta(self, delta: dict):
        op = delta.get("op")
        if op == "remove":
            self._removed_servers.add(delta["server_id"])
        elif op in ("add", "available"):
            # a re-released node is usable again (batch-system churn,
            # paper §5.3) — clear the tombstone
            self._removed_servers.discard(delta["server_id"])

    def _backoffs(self):
        """Exponential backoff schedule: base, doubling to the cap
        (§3.5) — the one implementation behind every retry loop.  With
        ``backoff_jitter=j`` each delay is scaled by a seeded draw in
        ``[1, 1+j)`` so clients hit by the same fault (e.g. a manager-
        shard crash, DESIGN.md §20) desynchronize their retry storms;
        draws come from the per-invoker jitter RNG, so the schedule is
        bit-identical per seed and differs across seeds."""
        b = self.backoff_base
        j = self.backoff_jitter
        rng = self._backoff_rng
        while True:
            yield b * (1.0 + j * rng.random()) if j else b
            b = min(b * 2, self.backoff_cap)

    # ----------------------------------------------------------- transport
    def _control(self, server_id: str) -> Channel:
        """Cached control channel to a manager: the connection-setup
        cost is paid on first contact only (warm reuse, §3.3)."""
        with self._lock:
            ch = self._ctrl.get(server_id)
            if ch is None or ch.closed:
                ch = self.fabric.connect(self.endpoint, server_id)
                self._ctrl[server_id] = ch
                self.stats.connections_opened += 1
            else:
                self.stats.connections_reused += 1
            return ch

    def _add_connection(self, conn: Connection):
        """Open one data channel per leased worker (paper §3.3: threads
        never share RDMA resources), THEN publish the connection — a
        concurrent dispatch never sees a worker without its channel."""
        with self._lock:
            for w in conn.process.workers:
                self._data[w.name] = self.fabric.connect(
                    self.endpoint, conn.manager.server_id)
            self._conns.append(conn)
            self._pairs_cache = None

    def _close_conn_locked(self, conn: Connection, faulted: bool = False):
        """Drop a connection's data channels (folding their counters
        into the retired totals); caller holds the lock.  ``faulted``
        marks the route broken so a late in-flight result cannot slip
        through a post-heal delivery window."""
        for w in conn.process.workers:
            ch = self._data.pop(w.name, None)
            if ch is not None:
                ch.fold_into(self._retired_wire)
                ch.close(faulted=faulted)

    def _note_fault(self, server_id: str):
        """Remember that this server's route just failed us — placement
        deprioritizes it for ``fault_memory_s`` (no point negotiating
        with a node the fabric keeps eating messages to)."""
        self._fault_at[server_id] = self.clock.now()

    def _placement_order(self, servers: List[ExecutorManager]) \
            -> List[ExecutorManager]:
        """Congestion- and fabric-aware placement (DESIGN.md §12/§14):
        random permutation (decentralized contention-spreading, §3.2),
        then a stable sort on ``(group, observed NIC load)`` — servers
        whose control channel is already cached (warm negotiation, no
        handshake) come first and recently-faulted ones last, and
        WITHIN each group the registry's per-node NIC utilization
        snapshot breaks ties: a server whose ports are busy with bulk
        transfers is asked after an idle one, so leases steer around
        congested links, not just around faults.  With no topology
        armed every load is 0 and the ordering reduces exactly to the
        fault-memory-only ranking.  Within equal keys the permutation's
        order stands, so two clients never converge on one target."""
        order = self._rng.sample(servers, len(servers))
        if len(order) <= 1:
            return order
        now = self.clock.now()
        ctrl, fault_at, memory = self._ctrl, self._fault_at, \
            self.fault_memory_s
        loads = self._replica.nic_loads()
        get_load = loads.get
        headroom = self.nic_headroom

        def rank(mgr: ExecutorManager) -> Tuple[int, int, int]:
            sid = mgr.server_id
            t = fault_at.get(sid)
            if t is not None and now - t < memory:
                group = 2                 # the fabric just failed us here
            else:
                ch = ctrl.get(sid)
                group = 0 if ch is not None and not ch.closed else 1
            load = get_load(sid, 0)
            # SLO-aware headroom (§18): a class with finite headroom
            # demotes servers whose NIC load snapshot already meets it,
            # steering premium leases to quiet nodes.  inf headroom
            # (standard/spot) never demotes, so the pre-QoS ordering
            # is reproduced bit-for-bit.
            return group, (1 if load >= headroom else 0), load

        order.sort(key=rank)
        return order

    def _candidate_servers(self) -> List[ExecutorManager]:
        """Allocation candidates: the replica's availability list minus
        tombstones, bounded by ``allocation_window`` on huge clusters —
        every cached-channel server is kept (warm reuse beats a random
        stranger), the remainder is a seeded sample."""
        removed = self._removed_servers
        servers = [s for s in self._replica.server_list()
                   if s.server_id not in removed]
        k = self.allocation_window
        if k is None or len(servers) <= k:
            return servers
        ctrl = self._ctrl
        cached, rest = [], []
        for s in servers:
            (cached if s.server_id in ctrl else rest).append(s)
        take = max(0, k - len(cached))
        if take:
            cached.extend(self._rng.sample(rest, min(take, len(rest))))
        return cached

    def transport_stats(self) -> dict:
        """Cumulative wire counters over this client's channels, open
        and retired — monotonic across failover and deallocate."""
        with self._lock:
            chans = list(self._ctrl.values()) + list(self._data.values())
            out = {"channels": len(chans), **self._retired_wire}
        for ch in chans:
            ch.fold_into(out)
        return out

    # ----------------------------------------------------------- allocation
    def allocate(self, n_workers: int, memory_bytes: int = 1 << 30,
                 timeout_s: float = 3600.0, sandbox: str = "bare",
                 mode: str = ALWAYS_WARM_INVOCATIONS) -> int:
        """Lease ``n_workers`` across servers; returns workers granted.
        Decentralized: random permutation of the replica's ranked list,
        direct negotiation over control channels, exponential backoff
        between rounds (which also absorbs lost negotiation messages)."""
        del mode                         # pre-allocation IS the warm mode
        remaining = n_workers
        delays = self._backoffs()
        for rnd in range(self.allocation_rounds):
            if remaining <= 0:
                break
            self.stats.allocation_rounds += 1
            servers = self._candidate_servers()
            if not servers:
                self.clock.sleep(next(delays))
                continue
            order = self._placement_order(servers)
            for mgr in order:
                if remaining <= 0:
                    break
                free = mgr.free_workers
                if free <= 0:
                    continue     # saturated: asking would only burn a
                    # guaranteed-rejected negotiation round trip
                ask = min(remaining, free)
                req = LeaseRequest(self.client_id, ask, memory_bytes,
                                   timeout_s, sandbox,
                                   lease_class=self.lease_class)
                self.stats.allocations_tried += 1
                ctrl = self._control(mgr.server_id)
                try:
                    ctrl.rpc(CONTROL_MSG_BYTES)   # lease negotiation
                except ChannelError:
                    self.stats.negotiation_faults += 1
                    self._note_fault(mgr.server_id)
                    continue     # lost/blocked rpc -> walk on, back off
                try:
                    proc = mgr.grant(req, self.library, channel=ctrl)
                except AllocationRejected:
                    continue             # immediate rejection -> walk on
                self._add_connection(Connection(mgr, proc))
                self.stats.allocations_granted += 1
                remaining -= ask
            if remaining > 0:
                self.clock.sleep(next(delays))                # §3.5
        return n_workers - remaining

    def allocate_batch(self, n_workers: int, *, lease_workers: int = 1,
                       memory_bytes: int = 1 << 30,
                       timeout_s: float = 3600.0, sandbox: str = "bare",
                       rounds: Optional[int] = None) -> int:
        """Batched lease acquisition for parallel clients (funcX-style
        batch submission): one availability snapshot and one placement
        pass per round, and per chosen server a SINGLE negotiation rpc
        that covers every lease requested from it —
        ``ceil(slice / lease_workers)`` leases of ``lease_workers``
        workers each — instead of one control round trip per lease.
        Acquiring W single-worker leases from S servers costs S rpcs,
        not W, while the fine lease granularity keeps elastic
        scale-down cheap (``release_workers`` hands back one worker,
        not a whole slab).  Returns the number of workers granted."""
        remaining = n_workers
        lease_workers = max(1, lease_workers)
        delays = self._backoffs()
        n_rounds = self.allocation_rounds if rounds is None else rounds
        for _ in range(n_rounds):
            if remaining <= 0:
                break
            self.stats.allocation_rounds += 1
            servers = self._candidate_servers()
            if not servers:
                self.clock.sleep(next(delays))
                continue
            for mgr in self._placement_order(servers):
                if remaining <= 0:
                    break
                free = mgr.free_workers
                if free <= 0:
                    continue
                ask = min(remaining, free)
                self.stats.allocations_tried += 1
                self.stats.batch_rpcs += 1
                ctrl = self._control(mgr.server_id)
                try:
                    ctrl.rpc(CONTROL_MSG_BYTES)   # one rpc, many leases
                except ChannelError:
                    self.stats.negotiation_faults += 1
                    self._note_fault(mgr.server_id)
                    continue
                while ask > 0:
                    take = min(lease_workers, ask)
                    req = LeaseRequest(self.client_id, take,
                                       memory_bytes, timeout_s, sandbox,
                                       lease_class=self.lease_class)
                    try:
                        proc = mgr.grant(req, self.library, channel=ctrl)
                    except AllocationRejected:
                        break            # raced another client: walk on
                    self._add_connection(Connection(mgr, proc))
                    self.stats.allocations_granted += 1
                    remaining -= take
                    ask -= take
            if remaining > 0:
                self.clock.sleep(next(delays))                # §3.5
        return n_workers - remaining

    def release_workers(self, n: int) -> int:
        """Elastic scale-down between fork-join iterations: hand leases
        back until about ``n`` workers are released (smallest leases
        first, so the give-back tracks the ask; lease granularity may
        overshoot by at most one lease).  Dead connections found along
        the way are reaped for free.  Returns workers released."""
        released = 0
        victims: List[Connection] = []
        with self._lock:
            order = sorted((c for c in self._conns if not c.private),
                           key=lambda c: len(c.process.alive_workers()))
            for c in order:
                if released >= n:
                    break
                victims.append(c)
                released += len(c.process.alive_workers())
                self._conns.remove(c)
                self._close_conn_locked(c)
            self._pairs_cache = None
        for c in victims:
            try:
                c.manager.release(c.process.lease.lease_id)
            except Exception:            # noqa: BLE001 — already dead
                pass
        return released

    def attach_private(self, manager: ExecutorManager, n_workers: int,
                       memory_bytes: int = 1 << 30) -> int:
        """Private executors (paper §3.5): job-internal capacity exposed
        through the same interface — used when public allocation starves."""
        req = LeaseRequest(self.client_id, n_workers, memory_bytes,
                           3600.0, "bare", lease_class=self.lease_class)
        ctrl = self._control(manager.server_id)
        # same fault surface and the same tolerance as allocate():
        # transient losses back off and resend, only a severed route
        # (or exhausted retries) surfaces to the caller
        delays = self._backoffs()
        for attempt in range(self.max_retries + 1):
            try:
                ctrl.rpc(CONTROL_MSG_BYTES)
                break
            except ChannelDropped:
                self.stats.negotiation_faults += 1
                if attempt == self.max_retries:
                    raise
                self.clock.sleep(next(delays))
            except ChannelPartitioned:
                self.stats.negotiation_faults += 1
                raise
        proc = manager.grant(req, self.library, channel=ctrl)
        self._add_connection(Connection(manager, proc, private=True))
        return n_workers

    def deallocate(self):
        with self._lock:
            conns, self._conns = self._conns, []
            self._pairs_cache = None
            for c in conns:
                self._close_conn_locked(c)
        for c in conns:
            try:
                c.manager.release(c.process.lease.lease_id)
            except Exception:            # noqa: BLE001 — already dead
                pass

    def shutdown(self):
        """Full client teardown: release leases, detach from the
        availability bus, retire cached control channels.  A churned
        client must not keep costing the multicast fan-out forever."""
        self.deallocate()
        self.rm.bus.unsubscribe(self._on_delta)
        self.fabric.set_tenant_qos(self.endpoint)   # drop weight/cap entry
        with self._lock:
            for ch in self._ctrl.values():
                ch.fold_into(self._retired_wire)
                ch.close()
            self._ctrl.clear()

    # ------------------------------------------------------------- workers
    def _worker_pairs(self, cached: bool = False) \
            -> List[Tuple[ExecutorWorker, Connection, Channel]]:
        """Live (worker, connection, data-channel) triples.
        ``cached=True`` returns the last validated snapshot when nothing
        has changed — the dispatch fast path.  Staleness is safe: a dead
        worker or broken route in the snapshot surfaces as
        ``ExecutorCrash``/``ChannelError`` on use, which invalidates the
        cache and retries on fresh pairs."""
        if cached:
            pairs = self._pairs_cache
            if pairs is not None:
                return pairs
        with self._lock:
            dead = [c for c in self._conns if not c.alive()]
            for c in dead:               # disrupted connection -> drop (§3.5)
                self._conns.remove(c)
                self._close_conn_locked(c, faulted=True)
            data = self._data
            pairs = [(w, c, data[w.name]) for c in self._conns
                     for w in c.process.alive_workers()
                     if w.name in data]
            self._pairs_cache = pairs
            return pairs

    def _alive_workers(self) -> List[ExecutorWorker]:
        return [w for w, _, _ in self._worker_pairs()]

    # ------------------------------------------------- cohort fast path
    def cohort_pairs(self) \
            -> List[Tuple[ExecutorWorker, Connection, Channel]]:
        """The dispatch snapshot exactly as ``_dispatch``'s first sweep
        would see it: the validated cache when present, else a fresh
        validation.  The cohort path inspects these triples to decide
        whether a window can be simulated closed-form."""
        pairs = self._pairs_cache
        if pairs is None:
            pairs = self._worker_pairs()
        return pairs

    def take_rr(self, n: int) -> int:
        """Consume ``n`` round-robin dispatch slots in one step and
        return the first, so a vectorized cohort lands on exactly the
        worker sequence ``n`` scalar ``_dispatch`` calls would have
        used, and the next scalar dispatch continues the rotation
        unperturbed."""
        c0 = next(self._rr)
        self._rr = itertools.count(c0 + n)
        return c0

    def _drop_connection(self, conn: Connection):
        """A broken route is indistinguishable from a dead executor on
        the client side (§3.5): drop the cached connection."""
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
            self._pairs_cache = None
            self._close_conn_locked(conn, faulted=True)

    @property
    def n_workers(self) -> int:
        return len(self._alive_workers())

    def connections(self) -> List[Connection]:
        """Snapshot of cached connections (their processes + leases) —
        the public view for harnesses and tests."""
        with self._lock:
            return list(self._conns)

    def worker_cold_breakdowns(self) -> List[Dict[str, float]]:
        with self._lock:
            return [dict(c.process.cold_breakdown) for c in self._conns]

    # ----------------------------------------------------------- invocation
    def submit(self, fn_name: str, payload: Any,
               worker_hint: Optional[int] = None) -> RFuture:
        """Non-blocking submission -> RFuture (std::future analogue)."""
        idx = self.library.index_of(fn_name)
        inv = Invocation.make(idx, fn_name, payload)
        self.stats.invocations += 1
        try:
            self._dispatch(inv, worker_hint)
        except AllocationFailed:
            # nothing was sent and no worker holds the record — recycle
            # it instead of abandoning the pooled graph to the cycle
            # collector (the caller only ever sees the exception)
            inv.release()
            raise
        return self._wrap_retries(inv, fn_name, payload)

    def submit_prepared(self, inv: Invocation) -> Invocation:
        """Dispatch a caller-built (possibly pooled) invocation record
        — the replay hot path: the caller pre-resolved the function
        index and payload size, and observes completion through
        ``inv.on_complete`` instead of a future wrapper.  Raises
        ``AllocationFailed`` when no worker is reachable, exactly like
        ``submit``."""
        self.stats.invocations += 1
        self._dispatch(inv)
        return inv

    def invoke(self, fn_name: str, payload: Any,
               timeout: Optional[float] = 60.0) -> Any:
        """Blocking invocation."""
        return self.submit(fn_name, payload).get(timeout)

    def map(self, fn_name: str, payloads: List[Any],
            timeout: Optional[float] = 120.0) -> List[Any]:
        """Parallel invocations over all connected workers (§3.4):
        independent non-blocking writes, disjoint result buffers.
        ``timeout`` is ONE total budget for the whole gather — a single
        deadline computed up front — not a fresh allowance per future
        (which would let K stragglers wait K × timeout)."""
        futs = [self.submit(fn_name, p) for p in payloads]
        if timeout is None:
            return [f.get(None) for f in futs]
        deadline = self.clock.now() + timeout
        return [f.get(deadline - self.clock.now()) for f in futs]

    # ------------------------------------------------------------ internals
    def _dispatch(self, inv: Invocation, worker_hint: Optional[int] = None):
        """Send the invocation over the chosen worker's data channel
        (modeled inbound write stamped on the timeline), walking on to
        the next worker when the route or the executor is gone.  A pass
        where every failure was a transient loss (``ChannelDropped``)
        is retried with backoff — the reliable-channel contract — up to
        ``max_retries`` passes."""
        delays = None                     # built only if a retry happens
        for sweep in range(self.max_retries + 1):
            # first sweep rides the validated snapshot (dispatch fast
            # path, inlined — this is the innermost replay loop); any
            # failure below invalidates it, so retry sweeps revalidate
            # against live leases/workers
            pairs = self._pairs_cache if sweep == 0 else None
            if pairs is None:
                pairs = self._worker_pairs()
            elif not pairs:
                # the CACHED snapshot is empty but may be stale (leases
                # can have arrived since it was validated): revalidate
                # once.  A freshly-computed empty snapshot is already
                # authoritative — recomputing it could not observe
                # anything new.
                pairs = self._worker_pairs()
            if not pairs:
                raise AllocationFailed(
                    f"{self.client_id}: no live executor workers")
            n_pairs = len(pairs)
            start = (worker_hint if worker_hint is not None
                     else next(self._rr)) % n_pairs
            size = inv.bytes_in + _HDR_SIZE
            last_err: Optional[BaseException] = None
            saw_drop = False
            for k in range(n_pairs):
                worker, conn, ch = pairs[(start + k) % n_pairs]
                if ch.closed:                 # connection already dropped
                    continue
                try:
                    t_in = ch.send(size)
                except ChannelPartitioned as e:
                    self.stats.dispatch_faults += 1
                    self._note_fault(conn.manager.server_id)
                    self._drop_connection(conn)  # broken route == dead
                    last_err = e
                    continue
                except ChannelDropped as e:
                    self.stats.dispatch_faults += 1
                    self._note_fault(conn.manager.server_id)
                    last_err = e              # transient loss: keep conn
                    saw_drop = True
                    continue
                inv.timeline.net_in = t_in
                inv.via = ch
                try:
                    worker.submit(inv)
                    return
                except ExecutorCrash as e:
                    self._pairs_cache = None  # dead worker in snapshot
                    last_err = e
                    continue
            # any transient loss this pass is worth a resend — dead
            # workers/routes were pruned and won't be revisited
            if not (saw_drop and sweep < self.max_retries):
                break
            if delays is None:
                delays = self._backoffs()
            self.clock.sleep(next(delays))    # transient loss: resend
        raise AllocationFailed(
            f"{self.client_id}: no reachable executor workers"
            + (f" (last error: {last_err})" if last_err else ""))

    def _wrap_retries(self, inv: Invocation, fn_name: str,
                      payload: Any) -> "RetryingFuture":
        """On ExecutorCrash, re-dispatch on another worker up to
        max_retries (bounded — avoids infinite invocations of broken
        functions, §3.5).  Retries run in the caller's thread inside
        ``get()`` — no per-invocation helper threads polluting the
        microsecond-scale dispatch path."""
        return RetryingFuture(self, inv, fn_name, payload)


class RetryingFuture:
    """RFuture facade with client-library retry semantics (§3.5)."""

    __slots__ = ("_invoker", "_cur", "_fn_name", "_payload", "_attempt")

    def __init__(self, invoker: Invoker, inv: Invocation, fn_name: str,
                 payload: Any):
        self._invoker = invoker
        self._cur = inv
        self._fn_name = fn_name
        self._payload = payload
        self._attempt = 0

    def done(self) -> bool:
        return self._cur.future.done()

    @property
    def invocation(self) -> Invocation:
        return self._cur

    @property
    def timeline(self):
        return self._cur.timeline

    def get(self, timeout: Optional[float] = 120.0) -> Any:
        """Blocking result fetch with crash-retries.  ``timeout`` is a
        single TOTAL budget: the deadline is computed once, and every
        retry attempt waits only the remaining slice — a crash partway
        through never restarts the clock (total wait stays bounded by
        ``timeout``, not ``(max_retries+1) × timeout``)."""
        clock = self._invoker.clock
        deadline = None if timeout is None else clock.now() + timeout
        while True:
            try:
                remaining = (None if deadline is None
                             else deadline - clock.now())
                return self._cur.future.get(remaining)
            except ExecutorCrash as e:
                self._attempt += 1
                if self._attempt > self._invoker.max_retries:
                    self._invoker.stats.failures += 1
                    raise
                self._invoker.stats.retries += 1
                failed = self._cur
                nxt = Invocation.make(failed.header.fn_index,
                                      self._fn_name, self._payload)
                nxt.retries = self._attempt
                # swap the facade to the retry record FIRST, then
                # recycle the crashed one: it is settled, the executor
                # dropped it, and nothing else can reach it through
                # this future anymore — abandoning it instead would
                # leak one pooled object graph per crash-retry
                self._cur = nxt
                failed.release()
                try:
                    self._invoker._dispatch(nxt)
                except AllocationFailed:
                    self._invoker.stats.failures += 1
                    raise e
