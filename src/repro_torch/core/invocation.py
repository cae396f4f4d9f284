"""Invocation protocol: header, payload accounting, futures, timelines.

The wire protocol mirrors the paper (§5.2): a 12-byte header (function
index, invocation id, return-buffer rkey) is RDMA-written with the
payload into the worker's buffer; the result is RDMA-written back with an
immediate value carrying (status, invocation id).  Here the "write" is an
in-process handoff over an explicit transport ``Channel`` (DESIGN.md
§12): the client's dispatch stamps the modeled inbound write on the
timeline, the executor's result return stamps the outbound one, and the
*measured* execution/dispatch times are recorded alongside so benchmarks
report paper-comparable round trips.
"""
from __future__ import annotations

import itertools
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np

from repro_torch.core.perf_model import NetParams, Sandbox, Tier, tier_overhead
from repro_torch.core.transport import fabric_params_for_net

#: dataclass(slots=True) where the interpreter supports it (3.10+):
#: these objects are minted once per invocation in 100k-scale replays.
SLOTS = {"slots": True} if sys.version_info >= (3, 10) else {}

_inv_ids = itertools.count(1)

#: free list of recycled invocation records (``Invocation.make`` pops,
#: ``Invocation.release`` pushes; list ops are GIL-atomic)
_POOL: List["Invocation"] = []


def payload_bytes(obj: Any) -> int:
    """Wire size of a payload: ndarray/bytes exact; pytrees summed."""
    if obj is None:
        return 0
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (list, tuple)):
        return sum(payload_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(payload_bytes(o) for o in obj.values())
    if isinstance(obj, (int, float, bool, np.number)):
        return 8
    return len(repr(obj).encode())


class InvocationHeader(NamedTuple):
    """12 wire bytes (paper §5.2); a NamedTuple, not a dataclass —
    frozen-dataclass construction costs a per-field object.__setattr__
    and headers are minted once per invocation on the hot path."""
    fn_index: int
    invocation_id: int
    return_buffer: int            # rkey/address analogue (opaque)

    SIZE = 12                     # bytes on the wire (paper §5.2)


@dataclass(**SLOTS)
class Timeline:
    """Modeled+measured event times (seconds, monotonic-origin)."""
    t_submit: float = 0.0
    net_in: float = 0.0           # modeled RDMA write (header+payload)
    overhead: float = 0.0         # modeled tier overhead (hot/warm/cold)
    exec_time: float = 0.0        # measured function execution
    net_out: float = 0.0          # modeled RDMA write of the result
    dispatch_measured: float = 0.0  # measured in-process dispatch cost

    @property
    def rtt_modeled(self) -> float:
        return self.net_in + self.overhead + self.exec_time + self.net_out

    @property
    def rtt_measured(self) -> float:
        return self.dispatch_measured + self.exec_time


#: guards lazy Event creation across concurrent waiters (slow path
#: only: no fulfilled-future or single-threaded flow ever touches it)
_LAZY_EVENT_LOCK = threading.Lock()


class _LazyEvent:
    """``threading.Event`` stand-in whose Condition machinery is built
    only when a thread actually blocks.  Futures on the simulated hot
    path are fulfilled and polled millions of times without ever
    waiting — paying a full Event construction per invocation is pure
    overhead there.  Concurrent waiters share ONE lazily-created Event
    (creation serialized by a module lock), so every blocked thread is
    woken, exactly like the real thing.  Safe under the GIL: waiters
    publish the Event before re-checking the flag, the setter raises
    the flag before reading the Event slot, so every interleaving
    either sees the flag or signals the Event."""

    __slots__ = ("_flag", "_ev")

    def __init__(self):
        self._flag = False
        self._ev = None

    def _reset(self):
        """Recycle (pool reuse): forget the flag AND any Event a past
        waiter built — the next lifecycle must not see a stale set."""
        self._flag = False
        self._ev = None

    def is_set(self) -> bool:
        return self._flag

    def set(self):
        self._flag = True
        ev = self._ev
        if ev is not None:
            ev.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._flag:
            return True
        ev = self._ev
        if ev is None:
            with _LAZY_EVENT_LOCK:    # all waiters share one Event
                ev = self._ev
                if ev is None:
                    ev = self._ev = threading.Event()
        if self._flag:                # set() may have missed the Event
            return True
        return ev.wait(timeout)


class RFuture:
    """std::future analogue (paper §5.1): blocking get(), non-blocking
    poll(); carries the timeline for latency accounting.

    Under a ``VirtualClock`` (``_clock`` is stamped by the worker at
    submission) a driver-thread ``get()`` pumps the simulated event loop
    instead of blocking, so single-threaded simulations never deadlock
    and timeouts are measured in simulated seconds.  Non-driver threads
    block on the real event instead — their timeout is wall-clock
    seconds, bounded regardless of whether the driver keeps advancing."""

    __slots__ = ("invocation", "_event", "_result", "_error", "_clock")

    def __init__(self, invocation: "Invocation"):
        self.invocation = invocation
        self._event = _LazyEvent()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._clock = None            # set on submit when virtual

    # executor side -----------------------------------------------------
    def _fulfill(self, result: Any):
        self._result = result
        ev = self._event                 # _LazyEvent.set, inlined
        ev._flag = True
        waiter = ev._ev
        if waiter is not None:
            waiter.set()
        cb = self.invocation.on_complete
        if cb is not None:
            cb(self.invocation, None)

    def _fail(self, err: BaseException):
        self._error = err
        already = self._event.is_set()
        self._event.set()
        if already:
            return                   # a second fault on an already-
            # settled future must not re-fire the completion hook
        cb = self.invocation.on_complete
        if cb is not None:
            cb(self.invocation, err)

    def _reset(self):
        self._event._reset()
        self._result = None
        self._error = None
        self._clock = None

    # client side -------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: Optional[float] = None) -> Any:
        clk = self._clock
        if (clk is not None and clk.virtual and clk.is_driver()
                and not self._event.is_set()):
            clk.wait_until(self._event.is_set, timeout)
            if not self._event.is_set():
                raise TimeoutError(
                    f"invocation {self.invocation.header.invocation_id} "
                    f"timed out after {timeout} simulated s")
        elif not self._event.wait(timeout):
            raise TimeoutError(
                f"invocation {self.invocation.header.invocation_id} timed "
                f"out after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def timeline(self) -> Timeline:
        return self.invocation.timeline


@dataclass(**SLOTS)
class Invocation:
    header: InvocationHeader
    fn_name: str
    payload: Any
    bytes_in: int
    timeline: Timeline = field(default_factory=Timeline)
    future: Optional[RFuture] = None
    tier: Tier = Tier.HOT
    sandbox: Sandbox = Sandbox.BARE
    retries: int = 0
    on_complete: Optional[Callable] = None
    #: data channel the invocation was dispatched on (transport.Channel);
    #: the executor returns the result over the same queue pair
    via: Optional[Any] = None

    @classmethod
    def make(cls, fn_index: int, fn_name: str, payload: Any,
             sandbox: Sandbox = Sandbox.BARE,
             nbytes: Optional[int] = None) -> "Invocation":
        """Mint (or recycle) one invocation record.  ``nbytes`` skips
        the payload-size walk when the caller already knows it (replay
        loops send the same payload object millions of times).

        Recycling: ``release()`` resets a COMPLETED record — invocation
        + timeline + future, one composite — and parks it on a
        free list this constructor pops from, so a million-invocation
        replay allocates a bounded working set instead of a million
        short-lived object graphs (each a future↔invocation reference
        CYCLE that only the cycle collector could reclaim).  Records
        are only recycled by owners who know no reference survives (the
        trace replayer after folding the timeline into its stats; the
        client retry path after a crash settles a record for good)."""
        b_in = payload_bytes(payload) if nbytes is None else nbytes
        hdr = InvocationHeader(fn_index, next(_inv_ids), 0)
        pool = _POOL
        if pool:
            try:
                inv = pool.pop()
            except IndexError:           # raced another maker
                inv = None
            if inv is not None:
                inv.header = hdr
                inv.fn_name = fn_name
                inv.payload = payload
                inv.bytes_in = b_in
                # the future was already reset by release(); the
                # stale timeline is NOT zeroed — every field is
                # overwritten before it is read on the success path
                # (t_submit/net_in at dispatch, exec_time/
                # dispatch_measured at completion, overhead/net_out in
                # finish_transport), and a failed record is only ever
                # recycled by the owner that observed the failure
                # (RetryingFuture, the trace replayer) after nothing
                # can read its timeline anymore
                inv.tier = Tier.HOT
                inv.sandbox = sandbox
                inv.retries = 0
                inv.on_complete = None
                inv.via = None
                return inv
        inv = cls(hdr, fn_name, payload, b_in, sandbox=sandbox)
        inv.future = RFuture(inv)
        return inv

    def release(self):
        """Return this record to the free list, fully reset.  ONLY for
        owners that know nothing holds the invocation, its timeline or
        its future anymore (see ``make``); everyone else just drops
        references."""
        self.payload = None
        self.via = None
        self.on_complete = None
        fut = self.future                # future + event reset, inlined
        fut._result = None
        fut._error = None
        fut._clock = None
        ev = fut._event
        ev._flag = False
        ev._ev = None
        _POOL.append(self)

    def finish_transport(self, bytes_out: int,
                         net: Optional[NetParams] = None):
        """Model the result write back over the dispatch channel plus
        the tier overhead, once tier and result size are known.  May
        raise ``ChannelError`` when the route home is gone (partition
        mid-execution) — the executor surfaces that as a crash and the
        client retries elsewhere (§3.5).  ``net`` is the fallback
        parameter set for channel-less direct submissions (no Invoker
        dispatch stamped ``via``/``net_in``): both wire components are
        modeled from it so their RTTs stay paper-comparable."""
        ch = self.via
        tl = self.timeline
        if ch is not None:
            tl.net_out = ch.deliver_result(bytes_out)
            tl.overhead = ch.fabric.tier_overhead(self.tier,
                                                  self.sandbox)
        elif net is not None:
            params = fabric_params_for_net(net)
            tl.net_in = params.message_time(
                self.bytes_in + InvocationHeader.SIZE)
            tl.net_out = params.message_time(bytes_out)
            tl.overhead = tier_overhead(self.tier, self.sandbox, net)
