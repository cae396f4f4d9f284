"""Executor managers and workers (paper §3.1, §3.3).

An ``ExecutorManager`` owns the spare capacity of one node (here: worker
slots + memory budget).  Clients negotiate leases DIRECTLY with managers
(decentralized allocation, §3.2) over control channels of the shared
transport fabric (DESIGN.md §12) — connection setup, the negotiation
message and the code push are all modeled channel traffic; a granted
lease spawns an ``ExecutorProcess`` — an isolated sandbox holding the
pushed function library and one ``ExecutorWorker`` per requested worker.  Workers
implement the hot/warm state machine: a worker is HOT (busy-polling, +326
ns modeled overhead) for ``hot_period`` seconds after each execution,
then falls back to WARM (event-blocked, +4.67 us modeled).  Crashes are
detected by the manager and surfaced to the client library, which retries
elsewhere (§3.5).

Time model: every timestamp is read from the manager's ``Clock``.  Under
the default ``RealClock`` each worker is a daemon thread draining a
queue, exactly the original behaviour.  Under a ``VirtualClock`` no
threads are spawned: ``submit`` appends to a FIFO (``_vqueue``) and a
one-slot dispatch loop (``_vkick``/``_vstart``/``_vfinish``) replays it
as simulated events — each execution occupies the worker for the
function library's modeled service time, and the completion event
re-kicks the queue at the same instant so queued successors observe the
hot window exactly like the real thread's drain.  A thousand
microsecond-scale invocations replay deterministically in microseconds
of simulated — and milliseconds of real — time.
"""
from __future__ import annotations

import itertools
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.accounting import Ledger
from repro_torch.core.clock import Clock, REAL_CLOCK
from threading import get_ident as _get_ident
from repro_torch.core.functions import FunctionLibrary
from repro_torch.core.invocation import Invocation, payload_bytes
from repro_torch.core.lease import (CLASS_PROTECTION, Lease, LeaseRequest,
                              LeaseState)
from repro_torch.core.perf_model import (DEFAULT_NET, NetParams, Sandbox, Tier,
                                   tier_overhead)
from repro_torch.core.transport import (Channel, ChannelError, CONTROL_MSG_BYTES,
                                  Fabric, fabric_params_for_net)


class ExecutorCrash(RuntimeError):
    """Function or executor process died; client library retries."""


class AllocationRejected(RuntimeError):
    pass


_STOP = object()


def _holds_cuda_tensor(x, torch) -> bool:
    """Whether a function result (tensor, or dict/list/tuple of them)
    holds a tensor that lives on the card."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return False
    return any(_holds_cuda_tensor(v, torch) for v in x)


class ExecutorWorker(threading.Thread):
    """One function instance: independent queue + completion channel
    (threads do not share RDMA resources, §3.3).  Virtual-clock workers
    never start the thread; execution happens as clock events."""

    def __init__(self, name: str, library: FunctionLibrary,
                 sandbox: Sandbox, hot_period: float,
                 on_done: Callable, net: NetParams,
                 fault_rate: float = 0.0, seed: int = 0,
                 clock: Clock = REAL_CLOCK):
        super().__init__(name=name, daemon=True)
        self.library = library
        self.sandbox = sandbox
        self.hot_period = hot_period
        self.on_done = on_done
        self.net = net
        self.fault_rate = fault_rate
        self.clock = clock
        self._rng = random.Random(seed)
        self._q: "queue.Queue" = queue.Queue()
        self._last_activity: Optional[float] = None
        self._busy_until: Optional[float] = None   # virtual-mode only
        self.busy_seconds = 0.0
        self.n_invocations = 0
        self.alive_flag = True
        self._stopped = False
        # orders submit() against stop()/crash(): nothing can enqueue
        # behind _STOP and strand a future until its timeout
        self._submit_lock = threading.Lock()
        # virtual-mode dispatch state: FIFO queue + one in-flight slot,
        # mirroring the real thread draining its queue one item at a time
        self._vqueue: "deque[Invocation]" = deque()
        self._vactive = False
        self._inflight_id: Optional[int] = None
        self._pending: Dict[int, Invocation] = {}
        # (version, idx) -> (fn, svc) memo: the virtual hot path runs
        # ONE symbol millions of times; a version bump on register
        # invalidates (indices shift when symbols re-sort)
        self._entry_key = (-1, -1)
        self._entry_val = (None, 0.0)

    # ------------------------------------------------------------- client
    def submit(self, inv: Invocation):
        if not self.alive_flag or self._stopped:
            raise ExecutorCrash(f"worker {self.name} is dead")
        clock = self.clock
        inv.timeline.t_submit = clock._now if clock.virtual \
            else clock.now()
        if inv.future is not None:
            inv.future._clock = clock
        if clock.virtual:
            # inlined _vsubmit + kick: when the worker is idle, the
            # invocation starts directly (skipping a deque round-trip)
            # — the dominant case of the million-invocation replay
            with self._submit_lock:
                self._pending[inv.header.invocation_id] = inv
                if self._vactive:
                    self._vqueue.append(inv)
                    start = None
                elif self._vqueue:       # defensive: FIFO order even if
                    self._vqueue.append(inv)   # idle with a backlog
                    self._vactive = True
                    start = self._vqueue.popleft()
                else:
                    self._vactive = True
                    start = inv
            if start is not None:
                if _get_ident() == clock._driver_ident:
                    self._vexec(start)  # same thread, same instant: the
                    # entry cannot have been crashed away in between
                else:
                    # non-driver submit (ServeEngine): execution stays
                    # a driver-side event, exactly as before
                    clock.call_later(0.0, self._vstart, start)
        else:
            with self._submit_lock:
                if not self.alive_flag or self._stopped:
                    raise ExecutorCrash(f"worker {self.name} is dead")
                self._q.put(inv)

    @property
    def tier(self) -> Tier:
        """HOT while the post-execution busy-poll window is open."""
        if self._last_activity is None:
            return Tier.WARM
        if self.clock.now() - self._last_activity <= self.hot_period:
            return Tier.HOT
        return Tier.WARM

    def has_pending(self) -> bool:
        """Queued OR in-flight work — identical meaning in both modes,
        so retrieve()'s grace drain waits out a mid-execution
        invocation on either clock.  Real mode counts via the queue's
        unfinished-task counter (decremented only after processing),
        which has no dequeued-but-not-yet-executing blind window."""
        if self.clock.virtual:
            return bool(self._pending)
        return self._q.unfinished_tasks > 0

    def stop(self):
        """Graceful: already-queued work drains, new submits refused
        (real mode queues _STOP behind pending items for the same
        effect)."""
        with self._submit_lock:
            self._stopped = True
            if not self.clock.virtual:
                self._q.put(_STOP)

    def crash(self):
        """Fault injection: the process dies mid-flight."""
        with self._submit_lock:
            self.alive_flag = False
            if not self.clock.virtual:
                self._q.put(_STOP)
        if self.clock.virtual:
            # real-mode parity: the in-flight invocation completes (a
            # running function cannot be interrupted there); only
            # queued work fails
            self._fail_pending(ExecutorCrash(
                f"worker {self.name} terminated"),
                keep_id=self._inflight_id)

    # ------------------------------------------- executor (real threads)
    def _drain_queue_failing(self):
        """Fail anything still queued behind a crash/stop, so queued
        clients get an immediate ExecutorCrash (and retry) instead of
        blocking until their timeout."""
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return
            self._q.task_done()
            if nxt is not _STOP and nxt.future:
                nxt.future._fail(ExecutorCrash(
                    f"worker {self.name} terminated"))

    def run(self):
        # lazy torch: only real executor threads need it (the virtual
        # path never does, and a core-only session saves the torch
        # import).  Imported HERE, before any timed region — inside the
        # invocation loop it would land on the first invocation's
        # measured exec_time as a warm-tier outlier.
        import torch
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                self._drain_queue_failing()
                return
            inv: Invocation = item
            inv.tier = self.tier
            inv.sandbox = self.sandbox
            t0 = time.perf_counter()
            try:
                if not self.alive_flag or (self.fault_rate and
                                           self._rng.random()
                                           < self.fault_rate):
                    self.alive_flag = False
                    raise ExecutorCrash(
                        f"function crashed executor {self.name}")
                fn = self.library.by_index(inv.header.fn_index)
                result = fn(inv.payload)
                if _holds_cuda_tensor(result, torch):
                    # the card runs asynchronously: wait for it, or
                    # exec_time measures only the enqueue
                    torch.cuda.synchronize()
                exec_time = time.perf_counter() - t0
                inv.timeline.exec_time = exec_time
                inv.timeline.dispatch_measured = max(
                    0.0, self.clock.now() - inv.timeline.t_submit
                    - exec_time)
                self._complete(inv, result, exec_time)
            except BaseException as e:  # noqa: BLE001 — forwarded to client
                exec_time = time.perf_counter() - t0
                self.on_done(self, inv, exec_time, e)
                inv.future._fail(e if isinstance(e, ExecutorCrash)
                                 else ExecutorCrash(repr(e)))
                if not self.alive_flag:
                    # mirror virtual-mode _fail_pending: queued work
                    # behind the crash fails now, not at its timeout
                    self._drain_queue_failing()
                    return
            finally:
                self._q.task_done()

    # --------------------------------------- executor (simulated events)
    # _vqueue/_vactive/_pending/_inflight_id are guarded by
    # _submit_lock: non-driver threads may submit while driver-side
    # clock callbacks dispatch (ServeEngine, backup_submit, rendezvous)
    def _vkick_locked(self, inline: bool = False):
        """Start the next queued invocation if the worker is free.
        Scheduled AFTER a completion event at the same instant, so a
        successor always observes the predecessor's _last_activity
        (tier HOT) — exactly like the real thread's FIFO drain.
        Caller holds _submit_lock.

        With ``inline=True`` and the clock driver calling, the next
        invocation is RETURNED instead of scheduled: the caller runs
        ``_vstart`` directly after releasing the lock (same simulated
        instant, same ordering, one less heap event on the hot path —
        a third of the clock traffic in a 100k-invocation replay)."""
        if self._vactive or not self._vqueue:
            return None
        self._vactive = True
        nxt = self._vqueue.popleft()
        if inline and self.clock.is_driver():
            return nxt
        self.clock.call_later(0.0, self._vstart, nxt)
        return None

    def _vstart(self, inv: Invocation):
        """Scheduled-event entry: re-validate against crashes that may
        have hit between scheduling and firing, then execute."""
        with self._submit_lock:
            if inv.header.invocation_id not in self._pending:
                self._vactive = False     # crashed while queued
                self._vkick_locked()
                return
        self._vexec(inv)

    def _vexec(self, inv: Invocation):
        """Execute one invocation (virtual mode).  Inline callers
        (driver thread, same instant as the kick that popped ``inv``)
        come here directly — nothing can have crashed the worker in
        between, so the pending re-check is skipped."""
        la = self._last_activity          # tier property, inlined
        # virtual-only path: _now is the clock's lock-free time field
        inv.tier = Tier.HOT if (la is not None and self.clock._now - la
                                <= self.hot_period) else Tier.WARM
        inv.sandbox = self.sandbox
        if not self.alive_flag or (self.fault_rate and
                                   self._rng.random() < self.fault_rate):
            self.alive_flag = False
            err = ExecutorCrash(f"function crashed executor {self.name}")
            with self._submit_lock:
                self._pending.pop(inv.header.invocation_id, None)
            self.on_done(self, inv, 0.0, err)
            inv.future._fail(err)
            self._fail_pending(ExecutorCrash(
                f"worker {self.name} terminated"))
            return
        lib = self.library
        try:
            key = (lib.version, inv.header.fn_index)
            if key == self._entry_key:
                fn, svc = self._entry_val
            else:
                fn, svc = lib.entry(inv.header.fn_index)
                self._entry_key = key
                self._entry_val = (fn, svc)
            result = fn(inv.payload)
        except BaseException as e:  # noqa: BLE001 — forwarded to client
            with self._submit_lock:
                self._pending.pop(inv.header.invocation_id, None)
            self.on_done(self, inv, 0.0, e)
            inv.future._fail(e if isinstance(e, ExecutorCrash)
                             else ExecutorCrash(repr(e)))
            with self._submit_lock:
                self._vactive = False
                self._vkick_locked()
            return
        # single GIL-atomic store: concurrent readers (crash from
        # another thread) see either the old or the new id, both safe
        self._inflight_id = inv.header.invocation_id
        # busy horizon for the vectorized cohort: when this execution
        # (and thus the worker, absent queued work) will finish
        self._busy_until = self.clock._now + svc
        # discard variant: the completion event is never cancelled
        # (crashes leave it to no-op via the pending check), so the
        # event object recycles through the clock's free list
        self.clock.call_later_discard(svc, self._vfinish, inv, result,
                                      svc)

    def _vfinish(self, inv: Invocation, result, svc: float):
        with self._submit_lock:
            if self._inflight_id == inv.header.invocation_id:
                self._inflight_id = None
            present = self._pending.pop(inv.header.invocation_id, None)
        if present is None:
            return                    # crashed mid-execution
        tl = inv.timeline
        tl.exec_time = svc
        d = self.clock._now - svc - tl.t_submit    # queueing delay
        tl.dispatch_measured = d if d > 0.0 else 0.0
        self._complete(inv, result, svc)
        # inlined kick (this runs on the driver — _vfinish is a clock
        # event): pop the FIFO successor or go idle, one lock
        with self._submit_lock:
            q = self._vqueue
            if q:
                nxt = q.popleft()         # _vactive stays True
            else:
                nxt = None
                self._vactive = False
        if nxt is not None:
            self._vexec(nxt)              # successor, same instant

    def _complete(self, inv: Invocation, result, exec_time: float):
        """Deliver the result home and retire the invocation — shared
        by the threaded and virtual paths so their semantics cannot
        drift.  The work ran regardless of delivery: the tier window,
        worker counters AND billing all advance (§5.4 accounts executed
        compute); only the future observes a broken route — the client
        sees a dead connection and retries elsewhere (§3.5)."""
        derr: Optional[BaseException] = None
        try:
            inv.finish_transport(0 if result is None
                                 else payload_bytes(result),
                                 net=self.net)
        except ChannelError as ce:
            derr = ExecutorCrash(f"result return failed: {ce}")
        clk = self.clock
        self._last_activity = clk._now if clk.virtual else clk.now()
        self.busy_seconds += exec_time
        self.n_invocations += 1
        # delivered=False when the result leg broke: the compute is
        # still billed (the work ran), but the INVOCATION count is not
        # — the client's retry re-executes and the eventual successful
        # delivery is the one counted (§5.4; previously a crash-retried
        # invocation double-counted ClientBill.invocations)
        self.on_done(self, inv, exec_time, None, derr is None)
        if derr is not None:
            inv.future._fail(derr)
        else:
            inv.future._fulfill(result)

    # ------------------------------------------------- cohort fast path
    def vectorizable(self) -> bool:
        """True when the worker's executions can be simulated
        closed-form by the vectorized replay path: alive, not stopping,
        and fault-free.  The fault check matters for determinism, not
        just speed — a faulty worker consumes its RNG per execution, so
        it must stay on the scalar path where every draw happens.
        In-flight or queued work does NOT disqualify: the cohort seeds
        its FIFO recurrence from ``cohort_seed`` and the pending
        completions fire (and bill) independently mid-window."""
        return (self.alive_flag and not self._stopped
                and not self.fault_rate)

    def cohort_seed(self, queued_svc: float) -> Optional[float]:
        """When this worker frees up, as the cohort must assume it:
        the in-flight execution's finish time plus ``queued_svc``
        seconds per FIFO-queued invocation (the replay runs one
        function, so every queued item costs the same service time).
        ``None`` when the worker has never executed — the cohort seeds
        WARM from the first arrival."""
        bu = self._busy_until
        if bu is None:
            bu = self._last_activity     # threaded-mode history only
            if bu is None:
                return None
        return bu + queued_svc * len(self._vqueue)

    def absorb_cohort(self, n: int, busy_s: float,
                      last_activity: float):
        """Charge ``n`` already-simulated executions (``busy_s`` total
        service time, last one finishing at ``last_activity``) to this
        worker's counters.  The cohort path computed tiers/finish times
        itself; this records exactly what ``n`` scalar ``_complete``
        calls would have, and advances the busy horizon so the NEXT
        cohort queues behind this one."""
        self.busy_seconds += busy_s
        self.n_invocations += n
        self._last_activity = last_activity
        self._busy_until = last_activity

    def _fail_pending(self, err: ExecutorCrash,
                      keep_id: Optional[int] = None):
        """Fail queued work; ``keep_id`` (the in-flight invocation)
        survives and completes, matching real-thread crash semantics."""
        with self._submit_lock:
            pending, self._pending = self._pending, {}
            if keep_id is not None and keep_id in pending:
                self._pending[keep_id] = pending.pop(keep_id)
            self._vqueue.clear()
            if not self._pending:
                self._vactive = False
        for inv in pending.values():
            if inv.future is not None:
                inv.future._fail(err)


@dataclass
class ExecutorProcess:
    """Sandbox + workers for one lease (paper: executor process)."""
    lease: Lease
    workers: List[ExecutorWorker]
    library: FunctionLibrary
    cold_breakdown: Dict[str, float] = field(default_factory=dict)

    @property
    def cold_time_modeled(self) -> float:
        return sum(self.cold_breakdown.values())

    def alive_workers(self) -> List[ExecutorWorker]:
        return [w for w in self.workers if w.alive_flag]


class ExecutorManager:
    """Per-node manager: connects clients, spawns/collects containerized
    executors, accounts resource consumption (paper §3.1)."""

    def __init__(self, server_id: str, n_workers: int, memory_bytes: int,
                 ledger: Ledger, *, sandbox: str = "bare",
                 hot_period: float = 1.0, net: NetParams = DEFAULT_NET,
                 fault_rate: float = 0.0, seed: int = 0,
                 clock: Clock = REAL_CLOCK,
                 fabric: Optional[Fabric] = None):
        self.server_id = server_id
        self.capacity_workers = n_workers
        self.capacity_memory = memory_bytes
        self.ledger = ledger
        self.sandbox = Sandbox(sandbox)
        self.hot_period = hot_period
        # the shared transport fabric: clients negotiate leases and push
        # code over its control channels; a legacy bare ``net`` argument
        # gets a private rdma-style fabric with the same parameters
        self.fabric = fabric if fabric is not None else Fabric(
            fabric_params_for_net(net), clock=clock, seed=seed)
        self.net = self.fabric.net
        self.fault_rate = fault_rate
        self.clock = clock
        self._seed = seed
        self._lock = threading.RLock()
        self._processes: Dict[int, ExecutorProcess] = {}
        # per-manager lease ids keep simulated runs reproducible (global
        # counters would leak state between same-process scenario runs)
        self._lease_ids = itertools.count(1)
        self._free_workers = n_workers
        self._free_memory = memory_bytes
        self._alive = True
        self._accepting = True
        self.on_saturated: Optional[Callable] = None     # -> resource mgr
        self.on_available: Optional[Callable] = None

    # --------------------------------------------------------------- state
    @property
    def free_workers(self) -> int:
        with self._lock:
            return self._free_workers

    def heartbeat(self) -> bool:
        return self._alive

    def hosted_protection(self) -> int:
        """Preemption rank of this node's most-protected live lease
        (spot 0 < standard 1 < premium 2, ``lease.CLASS_PROTECTION``).
        A node with no live leases ranks as standard — the batch
        system's spot-first ordering then leaves all-standard clusters
        in the exact pre-QoS node-id order (§18)."""
        with self._lock:
            procs = list(self._processes.values())
        ranks = [CLASS_PROTECTION[p.lease.request.lease_class]
                 for p in procs]
        return max(ranks) if ranks else CLASS_PROTECTION["standard"]

    def describe(self) -> dict:
        with self._lock:
            return {"server_id": self.server_id,
                    "free_workers": self._free_workers,
                    "free_memory": self._free_memory,
                    "sandbox": self.sandbox.value}

    # ----------------------------------------------------------- allocation
    def grant(self, request: LeaseRequest, library: FunctionLibrary,
              channel: Optional[Channel] = None) -> ExecutorProcess:
        """Direct client->manager negotiation.  Rejection is IMMEDIATE
        (paper §3.3 cold): no queueing, the client walks on.

        ``channel`` is the client's cached control channel: its one-time
        setup cost lands in the cold breakdown on first use only, so a
        repeat allocation over the same connection is visibly warm."""
        with self._lock:
            if not (self._alive and self._accepting):
                raise AllocationRejected(f"{self.server_id} not accepting")
            if (request.n_workers > self._free_workers
                    or request.memory_bytes > self._free_memory):
                raise AllocationRejected(
                    f"{self.server_id}: insufficient capacity "
                    f"({self._free_workers}w free)")
            # quota admission (§18): the ledger's per-tenant held-worker
            # counter spans every manager, so a hoarder walking the
            # server list is refused everywhere at negotiation time.
            # The ledger lock nests strictly inside the manager lock
            # (leaf lock, never calls out).
            if not self.ledger.try_acquire_workers(request.client_id,
                                                   request.n_workers):
                raise AllocationRejected(
                    f"{self.server_id}: lease quota exhausted for "
                    f"{request.client_id}")
            self._free_workers -= request.n_workers
            self._free_memory -= request.memory_bytes
            lease = Lease(request, self.server_id,
                          lease_id=next(self._lease_ids), clock=self.clock)

        sandbox = Sandbox(request.sandbox) if request.sandbox else \
            self.sandbox
        t0 = time.perf_counter()
        workers = []
        for i in range(request.n_workers):
            w = ExecutorWorker(
                f"{self.server_id}/L{lease.lease_id}/w{i}", library,
                sandbox, self.hot_period, self._worker_done, self.net,
                self.fault_rate, seed=self._seed * 9973 + lease.lease_id
                * 131 + i, clock=self.clock)
            w.lease_id = lease.lease_id      # O(1) completion billing
            if not self.clock.virtual:
                w.start()
            workers.append(w)
        # measured spawn cost is wall-clock noise; zero it under
        # simulation so breakdowns stay bit-identical across runs
        spawn_measured = 0.0 if self.clock.virtual \
            else time.perf_counter() - t0

        # all control-plane wire costs flow through the transport layer:
        # connection setup (paid once per cached channel), the lease
        # negotiation message (already counted by the client's rpc, so
        # modeled only here), and the code push (§5.2 .so transfer —
        # counted, it rides the negotiation that just succeeded)
        connect_cost = (channel.take_setup() if channel is not None
                        else self.fabric.params.connect_cost)
        code_push = (channel.transfer(library.code_size)
                     if channel is not None
                     else self.fabric.message_time(library.code_size))
        proc = ExecutorProcess(lease, workers, library, cold_breakdown={
            "connect": connect_cost,
            "submit_allocation": (channel if channel is not None
                                  else self.fabric).message_time(
                                      CONTROL_MSG_BYTES),
            "code_push": code_push,
            "spawn_workers": tier_overhead(Tier.COLD, sandbox, self.net),
            "spawn_measured": spawn_measured,
        })
        lease.activate()
        with self._lock:
            self._processes[lease.lease_id] = proc
            if self._free_workers == 0 and self.on_saturated:
                self.on_saturated(self.server_id)
        return proc

    def release(self, lease_id: int,
                state: LeaseState = LeaseState.RELEASED):
        with self._lock:
            proc = self._processes.pop(lease_id, None)
        if proc is None:
            return
        for w in proc.workers:
            w.stop()
        lease = proc.lease
        lease.end(state)
        self.ledger.add_allocation(lease.request.client_id,
                                   lease.gb_seconds())
        self.ledger.release_workers(lease.request.client_id,
                                    lease.request.n_workers)
        with self._lock:
            was_full = self._free_workers == 0
            self._free_workers += lease.request.n_workers
            self._free_memory += lease.request.memory_bytes
            if was_full and self._accepting and self.on_available:
                self.on_available(self.server_id)

    def sweep_expired(self) -> List[int]:
        """End leases whose timeout elapsed (paper §3.2: the lease, not
        the manager, bounds how long a client may hold resources)."""
        now = self.clock.now()
        with self._lock:
            expired = [lid for lid, p in self._processes.items()
                       if p.lease.expired(now)]
        for lid in expired:
            self.release(lid, LeaseState.EXPIRED)
        return expired

    # --------------------------------------------------- batch system API
    def retrieve(self, grace_s: float = 0.0):
        """Batch system takes the node back (paper §5.3): stop accepting,
        let running work drain for grace_s, then terminate leases and
        send the final billing update."""
        with self._lock:
            self._accepting = False
            procs = list(self._processes.items())
        deadline = self.clock.now() + grace_s
        while self.clock.now() < deadline and any(
                w.has_pending() for _, p in procs for w in p.workers):
            self.clock.sleep(0.001)
        for lid, _ in procs:
            self.release(lid, LeaseState.RETRIEVED)
        self.ledger.flush()

    def restore(self):
        with self._lock:
            self._accepting = True
            self._alive = True

    def crash(self):
        """Uncontrolled shutdown: clients find out via broken connections
        (paper §3.5)."""
        with self._lock:
            self._alive = False
            # pop before billing: a racing release() that already
            # popped (and billed) a lease must not be billed again
            procs, self._processes = dict(self._processes), {}
            self._free_workers = self.capacity_workers
            self._free_memory = self.capacity_memory
        for lid, proc in procs.items():
            for w in proc.workers:
                w.crash()
            proc.lease.end(LeaseState.FAILED)
            self.ledger.add_allocation(proc.lease.request.client_id,
                                       proc.lease.gb_seconds())
            self.ledger.release_workers(proc.lease.request.client_id,
                                        proc.lease.request.n_workers)

    # ------------------------------------------------------------ internal
    def _worker_done(self, worker: ExecutorWorker, inv: Invocation,
                     exec_time: float, err: Optional[BaseException],
                     delivered: bool = True):
        if err is not None:
            return
        # lock-free dict read (GIL-atomic): a lease already released or
        # crashed has been popped, and its late completions — exactly as
        # before — are not billed
        proc = self._processes.get(worker.lease_id)
        if proc is not None:
            # off the critical path: accounting after completion
            # (§5.4).  Always under the ledger lock: even during a
            # virtual-clock replay another thread may legitimately
            # read bill()/totals() concurrently.  An undelivered
            # result bills its compute but count=0 invocations — the
            # client retry that eventually lands is the counted one
            self.ledger.add_compute(proc.lease.request.client_id,
                                    exec_time,
                                    count=1 if delivered else 0)
