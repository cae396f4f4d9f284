"""Deterministic time core: real and virtual clocks.

Everything time-coupled in the rFaaS reproduction (hot/warm tier windows,
lease expiry and GB-second metering, allocation backoff, heartbeat
sweeps, serving deadlines) reads time through a ``Clock`` instead of the
``time`` module.  ``RealClock`` preserves the original wall-clock
behaviour and is the default everywhere, so production paths are
unchanged.  ``VirtualClock`` is an event-driven simulated clock: time
only moves when the driver thread calls ``advance()``/``sleep()``, and
scheduled callbacks fire in deterministic ``(time, sequence)`` order.
That makes microsecond-scale behaviour — a 326 ns hot window, a 4.67 us
warm wakeup, a one-hour lease — testable exactly and instantly, with no
``time.sleep`` anywhere in the suite (see ``simulation.SimulatedCluster``
for the composed harness).

Event storage (DESIGN.md §15, the million-invocation hot path): the
clock owns an ``EventQueue``.  The default ``CalendarQueue`` is an
array-backed calendar queue / bucket wheel — O(1) schedule, O(1)
cancel (entry invalidation: a cancelled call is skipped when its bucket
drains, never surgically removed) and O(1) amortized pop, with the
bucket width adapting to the observed event cadence and far-future
events parked in an overflow list until the wheel re-anchors onto
them.  ``HeapEventQueue`` is the binary-heap reference implementation,
kept selectable (``VirtualClock(queue="heap")``) because the property
tests replay random schedule/reschedule/cancel sequences against BOTH
and require bit-identical pop order.

Threading: the driver thread owns the queue and steps it without any
lock; other threads hand new events over through an append-only inbox
(list.append is atomic under the GIL) that the driver folds in at each
loop iteration, and block in ``sleep()`` on a real event until the
driver advances past their deadline (deterministic rendezvous, bounded
by ``rendezvous_timeout`` real seconds so a missing driver surfaces as
an error instead of a hang).
"""
from __future__ import annotations

import heapq
import threading
import time
from operator import attrgetter
from threading import get_ident as _get_ident
from typing import Any, Callable, List, Optional, Tuple


class ScheduledCall:
    """Handle for a callback scheduled on a clock; ``cancel()``-able.
    ``repeating`` marks recurring maintenance events (heartbeats, lease
    sweeps) which never count as pending work for idle detection.
    ``seq`` is the clock-assigned FIFO tie-breaker within one instant."""

    __slots__ = ("when", "seq", "fn", "args", "cancelled", "fired",
                 "repeating", "timer", "pooled", "owner", "purged",
                 "shard")

    def __init__(self, when: float, fn: Callable, args: Tuple[Any, ...],
                 repeating: bool = False):
        self.when = when
        self.seq = 0
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.fired = False
        self.repeating = repeating
        self.timer: Optional[threading.Timer] = None   # real clock only
        self.pooled = False          # recyclable fire-and-forget event
        self.owner = None            # owning VirtualClock's cancel log
        self.purged = False          # no longer counted as pending work
        self.shard = 0               # owning event shard (DESIGN.md §19)

    def cancel(self):
        # entry invalidation: the queue skips cancelled entries when
        # their bucket (or heap head) drains — no structure surgery, no
        # lock, O(1) from any thread.  The owning clock's cancel log
        # (an atomic list append) lets the driver settle the
        # pending-work counter EXACTLY, so idle detection returns at
        # the current instant instead of advancing through armed
        # repeating events toward a dead deadline.
        if self.cancelled:
            return
        self.cancelled = True
        if self.timer is not None:
            self.timer.cancel()      # free the sleeping Timer thread now
        o = self.owner
        if o is not None:
            o.append(self)


class _RepeatingHandle(ScheduledCall):
    """Handle for ``call_repeating``: cancelling it also cancels the
    currently-armed tick, so no stale event lingers on the clock."""

    __slots__ = ("inner",)

    def __init__(self, when: float, fn: Callable, args: Tuple[Any, ...]):
        super().__init__(when, fn, args, repeating=True)
        self.inner: Optional[ScheduledCall] = None

    def cancel(self):
        super().cancel()
        if self.inner is not None:
            self.inner.cancel()


#: descending (when, seq) — buckets are sorted once on entry and popped
#: from the END, so the earliest event is always ``ready[-1]``
_EVENT_KEY = attrgetter("when", "seq")


class CalendarQueue:
    """Array-backed calendar queue (bucket event wheel).

    ``nbuckets`` buckets of ``width`` simulated seconds each cover the
    wheel horizon ``[cur, end)`` in absolute bucket indices
    (``int(when / width)``); events beyond the horizon wait in ``far``.
    Scheduling appends to a bucket (O(1)); popping drains the current
    bucket through ``ready`` — sorted descending by ``(when, seq)``
    once, then consumed from the end — and scans forward to the next
    non-empty bucket.  When the wheel empties, the queue RE-ANCHORS
    directly onto the earliest far event instead of stepping through
    empty buckets, so second-scale gaps cost O(far), not O(gap/width).

    Events landing at or before the drain cursor (same-instant chains
    scheduled from inside a callback, or late cross-thread arrivals)
    are merge-inserted into ``ready`` — the insertion point is found by
    walking from the minimum end, which is O(1) for the dominant
    now-instant case — preserving the exact ``(when, seq)`` total
    order the heap reference produces.

    The bucket width self-tunes: every ``ADAPT_EVERY`` pops the queue
    compares the observed mean event gap against the width and rebuilds
    (O(live entries)) when they drift by more than 4x, so one clock
    serves microsecond invocation storms and second-scale lease churn
    in the same run.  Everything is a deterministic function of the
    push sequence — adaptation reads only simulated time.

    ``oneshots`` counts live non-repeating entries (cancelled entries
    keep counting until their bucket drains and purges them — idle
    detection re-checks through ``peek_when()``, which purges)."""

    __slots__ = ("width", "inv_width", "nbuckets", "mask", "buckets",
                 "far", "ready", "cur", "end", "wheel_count",
                 "oneshots", "pops", "t_mark")

    MIN_WIDTH = 1e-7
    MAX_WIDTH = 1e-2
    ADAPT_EVERY = 4096

    def __init__(self, start: float = 0.0, *, width: float = 1e-6,
                 nbuckets: int = 2048):
        if nbuckets & (nbuckets - 1):
            raise ValueError("nbuckets must be a power of two")
        self.width = width
        self.inv_width = 1.0 / width
        self.nbuckets = nbuckets
        self.mask = nbuckets - 1
        self.buckets: List[List[ScheduledCall]] = \
            [[] for _ in range(nbuckets)]
        self.far: List[ScheduledCall] = []
        self.ready: List[ScheduledCall] = []
        self.cur = int(start * self.inv_width) - 1
        self.end = self.cur + nbuckets
        self.wheel_count = 0            # entries in buckets (not ready)
        self.oneshots = 0               # non-repeating entries anywhere
        self.pops = 0
        self.t_mark = start

    # ------------------------------------------------------------- write
    def push(self, call: ScheduledCall):
        idx = int(call.when * self.inv_width)
        if idx > self.cur:
            if idx < self.end:
                self.buckets[idx & self.mask].append(call)
                self.wheel_count += 1
            else:
                self.far.append(call)
        else:
            self._insert_ready(call)
        if not call.repeating:
            self.oneshots += 1

    def _insert_ready(self, call: ScheduledCall):
        """Merge into the sorted drain list.  ``ready`` is descending,
        so the walk starts at the minimum end — a same-instant chain
        event (the common case) breaks out immediately and lands as the
        new minimum-after-current entries with the same instant."""
        ready = self.ready
        i = len(ready)
        w, s = call.when, call.seq
        while i:
            c = ready[i - 1]
            if c.when > w or (c.when == w and c.seq > s):
                break
            i -= 1
        ready.insert(i, call)

    # -------------------------------------------------------------- read
    def _head(self) -> Optional[ScheduledCall]:
        """Earliest live entry (purging cancelled ones on the way), or
        None when the queue holds nothing live."""
        while True:
            ready = self.ready
            while ready:
                c = ready[-1]
                if not c.cancelled:
                    return c
                ready.pop()
                if not c.repeating and not c.purged:
                    c.purged = True
                    self.oneshots -= 1
            if self.wheel_count:
                cur = self.cur
                buckets = self.buckets
                mask = self.mask
                while True:             # bounded by nbuckets: the wheel
                    cur += 1            # is known non-empty
                    b = buckets[cur & mask]
                    if b:
                        break
                self.cur = cur
                self.wheel_count -= len(b)
                if len(b) > 1:
                    b.sort(key=_EVENT_KEY, reverse=True)
                # swap the drained ready list (empty here) back into
                # the bucket slot: one list allocation per bucket
                # transition saved on the innermost loop
                buckets[cur & mask] = ready
                self.ready = b
                continue
            if self.far:
                self._reseed()
                continue
            return None

    def _reseed(self):
        """The wheel is empty: re-anchor it directly onto the earliest
        far event (purging cancelled ones), skipping any number of
        empty buckets in O(far)."""
        keep: List[ScheduledCall] = []
        min_when = None
        for c in self.far:
            if c.cancelled:
                if not c.repeating and not c.purged:
                    c.purged = True
                    self.oneshots -= 1
                continue
            keep.append(c)
            if min_when is None or c.when < min_when:
                min_when = c.when
        self.far = []
        if not keep:
            return
        self.cur = int(min_when * self.inv_width) - 1
        self.end = self.cur + self.nbuckets
        buckets, mask, end = self.buckets, self.mask, self.end
        far_again = self.far
        for c in keep:
            idx = int(c.when * self.inv_width)
            if idx < end:
                buckets[idx & mask].append(c)
                self.wheel_count += 1
            else:
                far_again.append(c)

    def pop_due(self, target: float) -> Optional[ScheduledCall]:
        """Remove and return the earliest entry with ``when <= target``,
        or None (leaving the head parked for the next call).  The head
        search is inlined — this is the event loop's innermost call."""
        while True:
            ready = self.ready
            while ready:
                c = ready[-1]
                if c.cancelled:
                    ready.pop()
                    if not c.repeating and not c.purged:
                        c.purged = True
                        self.oneshots -= 1
                    continue
                if c.when > target:
                    return None
                ready.pop()
                if not c.repeating:
                    self.oneshots -= 1
                self.pops += 1
                if self.pops >= self.ADAPT_EVERY:
                    self._adapt(c.when)
                return c
            if self.wheel_count:
                cur = self.cur
                buckets = self.buckets
                mask = self.mask
                while True:             # bounded by nbuckets: the wheel
                    cur += 1            # is known non-empty
                    b = buckets[cur & mask]
                    if b:
                        break
                self.cur = cur
                self.wheel_count -= len(b)
                if len(b) > 1:
                    b.sort(key=_EVENT_KEY, reverse=True)
                # swap the drained ready list (empty here) back into
                # the bucket slot: one list allocation per bucket
                # transition saved on the innermost loop
                buckets[cur & mask] = ready
                self.ready = b
                continue
            if self.far:
                self._reseed()
                continue
            return None

    def peek_when(self) -> Optional[float]:
        c = self._head()
        return c.when if c is not None else None

    def settle_cancel(self, call: ScheduledCall):
        """Settle one cancel-log entry against the live-one-shot
        counter (the caller has already checked/flagged ``purged``)."""
        self.oneshots -= 1

    def try_reschedule(self, call: ScheduledCall, when: float,
                       seq: int) -> bool:
        """Same-bucket fast path for ``Clock.reschedule``: when the
        target instant lands in the SAME wheel bucket the call
        currently occupies, mutate ``when`` in place and stamp the
        fresh ``seq`` — no cancelled entry left to drain, no new
        allocation.  The congestion engine's reschedule storms
        (every transfer start/retire moves the next completion) hit
        this whenever the move is sub-bucket.

        Membership is derived, not stamped: a live non-repeating entry
        whose bucket index satisfies ``cur < idx < end`` is guaranteed
        to sit (unsorted) in ``buckets[idx & mask]`` — entries at
        ``idx <= cur`` were drained into ``ready`` (sorted: no in-place
        mutation allowed) and entries at ``idx >= end`` live in
        ``far``/re-anchored geometry.  Pop order stays bit-identical
        to cancel-and-rearm: the live (when, seq) set is the same."""
        if call.repeating:
            return False
        inv_width = self.inv_width
        idx = int(when * inv_width)
        if (idx != int(call.when * inv_width) or idx <= self.cur
                or idx >= self.end):
            return False
        call.when = when
        call.seq = seq
        return True

    # -------------------------------------------------------- adaptation
    def _adapt(self, now: float):
        """Every ``ADAPT_EVERY`` pops: retune the bucket width to the
        observed mean event gap (deterministic — reads simulated time
        only) and rebuild when it drifted by more than 4x."""
        self.pops = 0
        span = now - self.t_mark
        self.t_mark = now
        if span <= 0.0:
            return                      # same-instant burst: no signal
        gap = span / self.ADAPT_EVERY
        if gap < self.MIN_WIDTH:
            gap = self.MIN_WIDTH
        elif gap > self.MAX_WIDTH:
            gap = self.MAX_WIDTH
        w = self.width
        if gap > 4.0 * w or 4.0 * gap < w:
            self._rebuild(gap, now)

    def _rebuild(self, width: float, now: float):
        entries = []
        for lst in (self.ready, *self.buckets, self.far):
            for c in lst:
                if c.cancelled:
                    c.purged = True   # counter is re-derived below; a
                    # pending cancel-log entry must not decrement later
                else:
                    entries.append(c)
        for b in self.buckets:
            if b:
                b.clear()
        self.far = []
        self.ready = []
        self.width = width
        self.inv_width = 1.0 / width
        self.cur = int(now * self.inv_width) - 1
        self.end = self.cur + self.nbuckets
        self.wheel_count = 0
        self.oneshots = 0
        for c in entries:
            self.push(c)


class HeapEventQueue:
    """Binary-heap reference implementation of the event-queue
    contract: identical ``(when, seq)`` pop order, used by the
    calendar-queue equivalence property tests and selectable via
    ``VirtualClock(queue="heap")``."""

    __slots__ = ("heap", "oneshots")

    def __init__(self, start: float = 0.0):
        del start
        self.heap: List[Tuple[float, int, ScheduledCall]] = []
        self.oneshots = 0

    def push(self, call: ScheduledCall):
        heapq.heappush(self.heap, (call.when, call.seq, call))
        if not call.repeating:
            self.oneshots += 1

    def _purge_head(self) -> bool:
        heap = self.heap
        while heap:
            c = heap[0][2]
            if not c.cancelled:
                return True
            heapq.heappop(heap)
            if not c.repeating and not c.purged:
                c.purged = True
                self.oneshots -= 1
        return False

    def pop_due(self, target: float) -> Optional[ScheduledCall]:
        if not self._purge_head():
            return None
        when, _, c = self.heap[0]
        if when > target:
            return None
        heapq.heappop(self.heap)
        if not c.repeating:
            self.oneshots -= 1
        return c

    def peek_when(self) -> Optional[float]:
        if not self._purge_head():
            return None
        return self.heap[0][0]

    def _head(self) -> Optional[ScheduledCall]:
        if not self._purge_head():
            return None
        return self.heap[0][2]

    def settle_cancel(self, call: ScheduledCall):
        self.oneshots -= 1

    def try_reschedule(self, call: ScheduledCall, when: float,
                       seq: int) -> bool:
        return False                 # heap entries are keyed tuples:
        # no in-place move — the reference stays cancel-and-rearm


#: queue implementations by name (VirtualClock(queue=...))
EVENT_QUEUES = {"calendar": CalendarQueue, "heap": HeapEventQueue}


class ShardedEventQueue:
    """K per-shard event queues under ONE global ``(when, seq)`` total
    order (DESIGN.md §19).

    Each shard owns its own sub-queue (cursor, buckets, adaptation);
    ``push`` routes by the call's ``shard`` stamp and ``pop_due``
    returns the global minimum over the K heads — a linear scan, K is
    small — so the merged pop order is bit-identical to a single
    queue over the same events BY CONSTRUCTION (the shards partition
    the event set; seq is globally unique).

    ``lookahead`` is the conservative-window floor (minimum
    cross-shard latency): a pop is *windowed* when some OTHER shard's
    head lies within the popped event's lookahead window — the two
    shards could have executed those events concurrently under the
    window protocol.  ``windowed_pops / pops_total`` is the run's
    parallelism certificate: the fraction of events with concurrent
    work available on another shard at pop time."""

    __slots__ = ("shards", "n_shards", "lookahead", "pops_total",
                 "windowed_pops", "shard_pops")

    def __init__(self, start: float = 0.0, n_shards: int = 1, *,
                 lookahead: float = 0.0, queue: str = "calendar"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        cls = EVENT_QUEUES[queue]
        self.shards = [cls(start) for _ in range(n_shards)]
        self.n_shards = n_shards
        self.lookahead = lookahead
        self.pops_total = 0
        self.windowed_pops = 0
        self.shard_pops = [0] * n_shards

    @property
    def oneshots(self) -> int:
        return sum(q.oneshots for q in self.shards)

    def settle_cancel(self, call: ScheduledCall):
        self.shards[call.shard].oneshots -= 1

    def push(self, call: ScheduledCall):
        self.shards[call.shard].push(call)

    def try_reschedule(self, call: ScheduledCall, when: float,
                       seq: int) -> bool:
        return self.shards[call.shard].try_reschedule(call, when, seq)

    def pop_due(self, target: float) -> Optional[ScheduledCall]:
        best: Optional[ScheduledCall] = None
        best_q = None
        other = None                 # earliest head among OTHER shards
        for q in self.shards:
            c = q._head()
            if c is None:
                continue
            if best is None or c.when < best.when or \
                    (c.when == best.when and c.seq < best.seq):
                if best is not None and (other is None
                                         or best.when < other):
                    other = best.when
                best = c
                best_q = q
            elif other is None or c.when < other:
                other = c.when
        if best is None or best.when > target:
            return None
        self.pops_total += 1
        if other is not None and other <= best.when + self.lookahead:
            self.windowed_pops += 1
        self.shard_pops[best.shard] += 1
        return best_q.pop_due(target)

    def peek_when(self) -> Optional[float]:
        best = None
        for q in self.shards:
            w = q.peek_when()
            if w is not None and (best is None or w < best):
                best = w
        return best

    def safe_horizon(self, shard: int) -> float:
        """How far shard ``shard`` may advance without coordination:
        the earliest other-shard cursor plus the lookahead floor
        (conservative PDES window bound).  Infinite when no other
        shard holds events."""
        other = None
        for s, q in enumerate(self.shards):
            if s == shard:
                continue
            w = q.peek_when()
            if w is not None and (other is None or w < other):
                other = w
        if other is None:
            return float("inf")
        return other + self.lookahead

    def stats(self) -> dict:
        return {"n_shards": self.n_shards,
                "lookahead_s": self.lookahead,
                "pops_total": self.pops_total,
                "windowed_pops": self.windowed_pops,
                "shard_pops": list(self.shard_pops)}


class Clock:
    """Time source interface.  ``virtual`` distinguishes the two modes
    where behaviour must genuinely differ (thread spawning, event
    pumping); everything else is uniform."""

    virtual: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def call_later(self, delay: float, fn: Callable,
                   *args: Any) -> ScheduledCall:
        return self._call_at(self.now() + max(0.0, delay), fn, args)

    def call_at(self, when: float, fn: Callable,
                *args: Any) -> ScheduledCall:
        return self._call_at(when, fn, args)

    def _call_at(self, when: float, fn: Callable, args: Tuple[Any, ...],
                 *, repeating: bool = False) -> ScheduledCall:
        raise NotImplementedError

    def reschedule(self, call: ScheduledCall,
                   when: float) -> ScheduledCall:
        """Move a pending one-shot callback to ``when`` and return the
        live handle.  The congestion layer re-integrates transfer
        completion times whenever a transfer starts or ends — the next
        completion event moves constantly, and this is the one
        primitive it needs: cancel-and-rearm as a single call (O(1) on
        the calendar queue: flag + bucket append), with a no-op fast
        path when the instant is unchanged.  A call that already fired
        (or was cancelled) is simply re-armed fresh."""
        if not call.cancelled and not call.fired and call.when == when:
            return call               # already armed at that instant
        call.cancel()
        return self._call_at(when, call.fn, call.args,
                             repeating=call.repeating)

    def call_later_discard(self, delay: float, fn: Callable,
                           *args: Any) -> None:
        """``call_later`` for fire-and-forget events: the caller gets
        NO handle and promises never to cancel.  VirtualClock recycles
        the event object through a free list — the two hottest events
        of a replay (service completion, next arrival) each save an
        allocation.  Default implementation just forwards."""
        self._call_at(self.now() + max(0.0, delay), fn, args)

    def call_at_discard(self, when: float, fn: Callable,
                        *args: Any) -> None:
        """``call_at`` variant of ``call_later_discard``."""
        self._call_at(when, fn, args)

    def call_repeating(self, interval: float, fn: Callable,
                       *args: Any) -> ScheduledCall:
        """Run ``fn`` every ``interval`` seconds until the returned
        handle is cancelled (heartbeat sweeps, lease-expiry sweeps).
        Repeating events fire during ``advance``/``run_until`` but are
        invisible to idle detection — ``run_until_idle`` terminates
        even while they are armed."""
        handle = _RepeatingHandle(self.now() + interval, fn, args)

        def tick():
            if handle.cancelled:
                return
            fn(*args)
            if not handle.cancelled:
                handle.inner = self._call_at(
                    self.now() + interval, tick, (), repeating=True)
                handle.when = handle.inner.when   # next fire instant
        handle.inner = self._call_at(self.now() + interval, tick, (),
                                     repeating=True)
        return handle


class RealClock(Clock):
    """Wall-clock time: the original behaviour of the codebase."""

    virtual = False

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def _call_at(self, when: float, fn: Callable, args: Tuple[Any, ...],
                 *, repeating: bool = False) -> ScheduledCall:
        call = ScheduledCall(when, fn, args, repeating=repeating)

        def fire():
            if not call.cancelled:
                call.fired = True
                call.fn(*call.args)

        t = threading.Timer(max(0.0, when - self.now()), fire)
        t.daemon = True
        call.timer = t
        t.start()
        return call


#: Process-wide default; sharing one instance keeps ``clock is
#: REAL_CLOCK`` checks and monotonic origins consistent across modules.
REAL_CLOCK = RealClock()


class _Waiter:
    __slots__ = ("deadline", "wake", "ack")

    def __init__(self, deadline: float):
        self.deadline = deadline
        self.wake = threading.Event()
        self.ack = threading.Event()


class VirtualClock(Clock):
    """Event-driven simulated time.

    The *driver thread* (by default the creating thread) owns time: it
    advances the clock with ``advance()``/``run_until()``/``sleep()`` and
    pumps scheduled callbacks, which run inline on the driver thread in
    strict ``(when, seq)`` order.  Other threads may ``sleep()``; they
    block until the driver advances past their deadline (deterministic
    rendezvous, bounded by ``rendezvous_timeout`` real seconds so a
    missing driver surfaces as an error instead of a hang).

    ``queue`` selects the event store: ``"calendar"`` (default — the
    O(1) bucket wheel) or ``"heap"`` (the reference binary heap); both
    produce bit-identical event order.  The driver steps the store with
    NO lock — cross-thread scheduling goes through ``_inbox`` (atomic
    appends, folded in by the driver each loop iteration), and the only
    remaining lock guards the sleeper rendezvous list.
    """

    virtual = True

    def __init__(self, start: float = 0.0, *,
                 rendezvous_timeout: float = 30.0,
                 queue: str = "calendar", shards: int = 0,
                 shard_lookahead: float = 0.0):
        self._now = float(start)
        if shards:
            self._queue = ShardedEventQueue(
                start, shards, lookahead=shard_lookahead, queue=queue)
        else:
            self._queue = EVENT_QUEUES[queue](start)
        # events created while a shard hint is set are pinned to that
        # shard's sub-queue (DESIGN.md §19); 0 = coordinator shard.
        # Harmless when the queue is unsharded.
        self._shard_hint = 0
        self._inbox: List[ScheduledCall] = []
        self._call_pool: List[ScheduledCall] = []   # recycled events
        # handles cancelled from ANY thread land here (atomic append);
        # the driver settles the pending-work counter from it in
        # _has_work, restoring the exact idle-detection semantics of
        # the old eager per-cancel counter without a lock
        self._cancel_log: List[ScheduledCall] = []
        self._seq = 0
        # the lock guards only the waiter list; the event store is
        # driver-private (non-drivers hand events over via _inbox)
        self._lock = threading.Lock()
        self._driver = threading.current_thread()
        self._driver_ident = threading.get_ident()
        self._waiters: List[_Waiter] = []
        self._rendezvous_timeout = rendezvous_timeout
        self._woke_any = False
        self.events_run = 0

    # ------------------------------------------------------------ basics
    def now(self) -> float:
        # lock-free: a float attribute read is atomic under the GIL and
        # now() sits on every hot path (sends, tier checks, billing)
        return self._now

    def is_driver(self) -> bool:
        # ident comparison, not current_thread(): this check runs twice
        # per simulated invocation
        ident = self._driver_ident
        if ident is None:
            # driver was handed to a not-yet-started thread; its ident
            # only exists once it runs — resolve lazily, fall back to
            # object identity until then
            ident = self._driver.ident
            if ident is None:
                return threading.current_thread() is self._driver
            self._driver_ident = ident
        return threading.get_ident() == ident

    def set_driver(self, thread: Optional[threading.Thread] = None):
        """Hand time ownership to ``thread`` (default: caller)."""
        self._driver = thread or threading.current_thread()
        self._driver_ident = self._driver.ident   # None until started

    def call_later(self, delay: float, fn: Callable,
                   *args: Any) -> ScheduledCall:
        """One-shot in ``delay`` seconds — overridden to inline the
        driver fast path (one frame instead of three: this is half the
        scheduling traffic of a replay)."""
        now = self._now
        call = ScheduledCall(now + delay if delay > 0.0 else now,
                             fn, args)
        call.owner = self._cancel_log
        call.shard = self._shard_hint
        if _get_ident() == self._driver_ident:
            call.seq = self._seq
            self._seq += 1
            self._queue.push(call)
        else:
            self._inbox.append(call)
        return call

    def call_at(self, when: float, fn: Callable,
                *args: Any) -> ScheduledCall:
        """One-shot at absolute ``when`` — same inlined fast path."""
        call = ScheduledCall(when, fn, args)
        call.owner = self._cancel_log
        call.shard = self._shard_hint
        if _get_ident() == self._driver_ident:
            if when < self._now:
                call.when = self._now
            call.seq = self._seq
            self._seq += 1
            self._queue.push(call)
        else:
            self._inbox.append(call)
        return call

    def call_later_discard(self, delay: float, fn: Callable,
                           *args: Any) -> None:
        """Fire-and-forget ``call_later``: the event object comes from
        (and returns to) a free list — no allocation on the replay's
        two hottest scheduling sites.  DRIVER THREAD ONLY (the two
        callers are clock callbacks, which always run on the driver) —
        the identity check is skipped on this innermost path."""
        now = self._now
        when = now + delay if delay > 0.0 else now
        pool = self._call_pool
        if pool:
            call = pool.pop()
            call.when = when
            call.fn = fn
            call.args = args
            call.cancelled = False
            call.fired = False
        else:
            call = ScheduledCall(when, fn, args)
            call.pooled = True
        call.shard = self._shard_hint   # recycled events must re-stamp
        call.seq = self._seq
        self._seq += 1
        self._queue.push(call)

    def call_at_discard(self, when: float, fn: Callable,
                        *args: Any) -> None:
        """Fire-and-forget ``call_at``; DRIVER THREAD ONLY (see
        ``call_later_discard``)."""
        if when < self._now:
            when = self._now
        pool = self._call_pool
        if pool:
            call = pool.pop()
            call.when = when
            call.fn = fn
            call.args = args
            call.cancelled = False
            call.fired = False
        else:
            call = ScheduledCall(when, fn, args)
            call.pooled = True
        call.shard = self._shard_hint   # recycled events must re-stamp
        call.seq = self._seq
        self._seq += 1
        self._queue.push(call)

    def _call_at(self, when: float, fn: Callable, args: Tuple[Any, ...],
                 *, repeating: bool = False) -> ScheduledCall:
        call = ScheduledCall(when, fn, args, repeating=repeating)
        call.owner = self._cancel_log
        call.shard = self._shard_hint
        if self.is_driver():
            if when < self._now:
                call.when = self._now
            call.seq = self._seq
            self._seq += 1
            self._queue.push(call)
        else:
            # cross-thread handoff: list.append is atomic under the
            # GIL; the driver folds the inbox in (assigning seq and
            # clamping when) before its next queue operation
            self._inbox.append(call)
        return call

    def reschedule(self, call: ScheduledCall,
                   when: float) -> ScheduledCall:
        """Cancel-and-rearm with two fast paths: the no-op (instant
        unchanged) and the calendar queue's same-bucket in-place move
        (``CalendarQueue.try_reschedule``) — the reschedule-storm
        pattern of the congestion engine mostly moves a completion
        instant by less than a bucket, and the in-place move costs
        one int compare + two stores instead of an allocation plus a
        dead entry lingering until its bucket drains.  Both paths
        consume exactly one ``seq`` per move, so pop order stays
        bit-identical to the heap reference's cancel-and-rearm."""
        if not call.cancelled and not call.fired:
            if call.when == when:
                return call           # already armed at that instant
            if when >= self._now \
                    and _get_ident() == self._driver_ident \
                    and self._queue.try_reschedule(call, when,
                                                   self._seq):
                self._seq += 1
                return call
        call.cancel()
        sh = self._shard_hint
        if call.shard != sh:          # a moved event keeps its shard
            self._shard_hint = call.shard
            try:
                return self._call_at(when, call.fn, call.args,
                                     repeating=call.repeating)
            finally:
                self._shard_hint = sh
        return self._call_at(when, call.fn, call.args,
                             repeating=call.repeating)

    def _drain_inbox(self):
        inbox = self._inbox
        q = self._queue
        while inbox:
            try:
                call = inbox.pop(0)
            except IndexError:          # raced another drain (defensive)
                break
            if call.when < self._now:
                call.when = self._now
            call.seq = self._seq
            self._seq += 1
            q.push(call)

    # ---------------------------------------------------------- stepping
    def _has_work(self) -> bool:
        """Pending WORK: live one-shot callbacks or sleeping threads.
        Repeating maintenance events (heartbeats, sweeps) never count —
        an armed sweeper must not make idle unreachable.  The cancel
        log is settled first, so a cancelled one-shot buried behind an
        armed sweeper cannot report phantom work (which would make
        ``run_until_idle`` advance time toward a dead deadline)."""
        if self._inbox and self.is_driver():
            self._drain_inbox()      # inbox entries count once pushed
        log = self._cancel_log
        if log:
            q = self._queue
            while log:
                try:
                    c = log.pop()
                except IndexError:   # raced another driver call
                    break
                if c.repeating or c.fired or c.purged:
                    continue
                c.purged = True
                q.settle_cancel(c)
        return (self._queue.oneshots > 0 or bool(self._inbox)
                or bool(self._waiters))

    def foreign_activity(self) -> bool:
        """Cross-thread work the driver has not absorbed yet: threads
        sleeping on this clock, or inbox entries scheduled from
        off-driver threads.  The vectorized replay path refuses to
        compress a time window while any exists — a sleeper's wake or
        an unknown inbox callback could land mid-window and observe
        state the cohort would have fast-forwarded past.  Driver-side
        one-shot and repeating events are NOT foreign: the cohort's
        eligibility checks account for those explicitly."""
        return bool(self._waiters) or bool(self._inbox)

    def _next_due(self) -> Optional[float]:
        """Earliest pending instant: a scheduled callback (one-shot or
        repeating) or a sleeping thread's deadline."""
        if self._inbox and self.is_driver():
            self._drain_inbox()
        next_ev = self._queue.peek_when()
        if self._waiters:
            with self._lock:
                next_wait = min((w.deadline for w in self._waiters),
                                default=None)
        else:
            next_wait = None
        if next_ev is None:
            return next_wait
        if next_wait is None:
            return next_ev
        return min(next_ev, next_wait)

    def _wake_due_waiters(self):
        """Wake sleepers whose deadline has passed, in deadline order,
        waiting for each to acknowledge before proceeding."""
        while True:
            with self._lock:
                due = [w for w in self._waiters if w.deadline <= self._now]
                if not due:
                    return
                due.sort(key=lambda w: w.deadline)
                w = due[0]
                self._waiters.remove(w)
            self._woke_any = True
            w.wake.set()
            w.ack.wait(self._rendezvous_timeout)

    def run_until(self, target: float):
        """Advance to ``target``, firing every due callback and waking
        every due sleeper along the way, in time order.  The fast loop
        (no sleepers registered — every large replay) is lock-free:
        pop, stamp time, fire."""
        q = self._queue
        pop_due = q.pop_due
        inbox = self._inbox
        waiters = self._waiters
        pool = self._call_pool
        n_run = 0
        try:
            while True:
                if inbox:
                    self._drain_inbox()
                if waiters:
                    self.events_run += n_run
                    n_run = 0
                    if not self._step_with_waiters(target):
                        break
                    continue
                call = pop_due(target)
                if call is None:
                    break
                when = call.when
                if when > self._now:
                    self._now = when
                call.fired = True
                n_run += 1
                call.fn(*call.args)
                if call.pooled:
                    # fire-and-forget event: nobody holds a handle
                    # (the discard contract) — recycle the object
                    call.args = None
                    pool.append(call)
        finally:
            # exception-safe flush: a raising callback must not lose
            # the count of events that DID run (events_run doubles as
            # a determinism digest)
            self.events_run += n_run
        if target > self._now:
            self._now = target
        if waiters:
            self._wake_due_waiters()

    def _step_with_waiters(self, target: float) -> bool:
        """One careful step while sleeper threads are registered: fire
        the next event OR wake the next due sleeper, whichever comes
        first (events win ties, exactly like the historical single-heap
        loop).  Returns False when nothing is due at or before
        ``target``."""
        with self._lock:
            next_wait = min((w.deadline for w in self._waiters),
                            default=None)
        next_ev = self._queue.peek_when()
        if (next_ev is not None and next_ev <= target
                and (next_wait is None or next_ev <= next_wait)):
            call = self._queue.pop_due(target)
            if call is None:            # raced a cancel (defensive)
                return True
            if call.when > self._now:
                self._now = call.when
            call.fired = True
            self.events_run += 1
            call.fn(*call.args)
            if call.pooled:              # recycle here too: sleeper
                call.args = None         # threads must not disable the
                self._call_pool.append(call)   # discard free list
            if self._waiters:
                self._wake_due_waiters()
            return True
        if next_wait is not None and next_wait <= target:
            if next_wait > self._now:
                self._now = next_wait
            self._wake_due_waiters()
            return True
        return False

    def advance(self, dt: float):
        """Move time forward by ``dt`` simulated seconds."""
        if dt < 0:
            raise ValueError("cannot advance a clock backwards")
        self.run_until(self.now() + dt)

    def run_until_idle(self, max_time: Optional[float] = None):
        """Drain all pending WORK — one-shot callbacks and sleeping
        threads' deadlines (bounded by ``max_time`` if given).
        Repeating maintenance events fire along the way but never keep
        the loop alive, so this terminates with sweepers still armed."""
        while True:
            if self._has_work():
                # advance to the earliest event of ANY kind: repeating
                # events on the way to the work fire exactly as they
                # would inside one long run_until
                t = self._next_due()
                if t is not None and (max_time is None or t <= max_time):
                    self.run_until(t)
                    continue
                if t is None and not self._has_work():
                    continue          # "work" was only cancelled
                    # entries — the _next_due purge settled the counter
                break                 # work exists but beyond max_time
            if self._settle_after_rendezvous(
                    include_repeating=False) == "work":
                continue              # a woken sleeper enqueued more
            break
        if max_time is not None:
            self.run_until(max_time)

    # ---------------------------------------------------------- sleeping
    def sleep(self, seconds: float) -> None:
        seconds = max(0.0, seconds)
        if self.is_driver():
            self.advance(seconds)
            return
        with self._lock:
            waiter = _Waiter(self._now + seconds)
            if waiter.deadline <= self._now:
                return               # already due: don't register a
                # waiter the driver may never come back to wake
            self._waiters.append(waiter)
        if not waiter.wake.wait(self._rendezvous_timeout):
            with self._lock:
                still_registered = waiter in self._waiters
                if still_registered:
                    self._waiters.remove(waiter)
            if still_registered:
                waiter.ack.set()     # release a driver that arrives late
                raise RuntimeError(
                    "VirtualClock.sleep: driver never advanced past "
                    f"t={waiter.deadline:.6f} (real timeout)")
            # the driver woke us concurrently with our timeout: it has
            # already removed the waiter and is blocked on our ack —
            # this is a normal (if slow) wake, not an error
        waiter.ack.set()

    def wait_until(self, predicate: Callable[[], bool],
                   timeout: Optional[float] = None) -> bool:
        """Pump events until ``predicate()`` is true.  Driver thread
        only.  With a ``timeout`` (simulated seconds) time never advances
        beyond it; returns the final predicate value.  Without one,
        exhausting the event queue while the predicate is still false
        raises — that is a deadlock, not a wait."""
        if not self.is_driver():
            raise RuntimeError(
                "wait_until must be called from the driver thread")
        deadline = None if timeout is None else self.now() + timeout
        while not predicate():
            # only pending WORK counts: with timeout=None an armed
            # repeating sweeper must not turn deadlock into a hang
            include_rep = deadline is not None
            t = self._next_due() if (include_rep or self._has_work()) \
                else None
            if t is None:
                settled = self._settle_after_rendezvous(
                    predicate, include_repeating=include_rep)
                if settled == "predicate":
                    return True
                if settled == "work":
                    continue          # a woken sleeper enqueued more
                if deadline is None:
                    raise RuntimeError(
                        "VirtualClock deadlock: predicate false and no "
                        "pending work remains (only recurring "
                        "maintenance events and/or nothing at all)")
                self.run_until(deadline)
                return predicate()
            if deadline is not None and t > deadline:
                self.run_until(deadline)
                return (predicate() or self._settle_after_rendezvous(
                    predicate) == "predicate")
            self.run_until(t)
        return True

    def _settle_after_rendezvous(self, predicate=None, *,
                                 include_repeating: bool = True) -> str:
        """A woken sleeper runs concurrently after acknowledging; give
        it a short real-time grace to act — fulfill a future
        (``"predicate"``) or enqueue follow-up events (``"work"``) —
        before the driver concludes quiescence (``"quiet"``).  Costs
        nothing in single-threaded simulations (no waiter ever woken)."""
        def done() -> Optional[str]:
            if predicate is not None and predicate():
                return "predicate"
            pending = (self._next_due() is not None if include_repeating
                       else self._has_work())
            if pending:
                return "work"
            return None

        if not self._woke_any:
            return done() or "quiet"
        t_end = time.monotonic() + min(1.0, self._rendezvous_timeout)
        while time.monotonic() < t_end:
            outcome = done()
            if outcome:
                return outcome
            time.sleep(0.0005)
        # one full grace with no progress: stop paying it on every
        # subsequent wait until another sleeper is actually woken
        self._woke_any = False
        return done() or "quiet"
