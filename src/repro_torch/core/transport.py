"""Unified transport fabric: every cross-node interaction as a channel
(paper §3.3 connection caching, §3.4 UD multicast, §5.2 wire protocol;
DESIGN.md §12).

rFaaS's performance claim lives in the transport: RDMA queue pairs with
inline writes, connections cached across invocations, and one-way
microsecond latencies (§3.3, §6.1).  This module makes that layer
explicit instead of leaving it scattered across ad-hoc ``write_time``
calls:

* ``FabricParams`` — a named, frozen parameter set describing one
  transport technology: the LogfP ``NetParams`` plus per-connection
  setup cost, a wire-encoding expansion factor (other platforms base64
  their payloads, Fig. 1), and the default reliability class.  The
  ``FABRICS`` registry carries the calibrated presets: ``rdma`` (the
  paper's testbed — identical numbers to ``perf_model.DEFAULT_NET``),
  ``tcp`` (rFaaS software over a kernel TCP stack), ``nightcore``
  (microsecond dispatcher, TCP + JSON — the strongest Fig.-1 baseline)
  and ``local`` (same-host shared memory).

* ``Fabric`` — the runtime instance: owns the shared ``Clock``, a seeded
  RNG for fault injection, the set of known endpoints and the active
  partitions.  ``connect()`` returns a reliable channel (RC queue-pair
  analogue), ``datagram()`` an unreliable one (UD analogue, used by the
  availability multicast).  ``partition(a, b)`` severs connectivity
  between two endpoint groups until ``heal()``; ``one_way=True`` severs
  only the a→b direction (asymmetric failure: a link that still
  delivers requests but eats the replies — heartbeat rpcs and result
  returns notice via the return-route check even though the forward
  send succeeds).

* ``Channel`` — one queue pair: ``send()`` models the wire time of a
  message through the shared clock's timeline and returns it, updating
  per-channel byte/message counters; injected faults surface as
  ``ChannelDropped`` (lost message, reliable channels — the caller
  backs off and retries, §3.5) or ``ChannelPartitioned`` (no route),
  while unreliable channels swallow losses silently (datagram
  semantics, §3.4).  The connection-setup cost is charged once per
  channel via ``take_setup()`` — the explicit form of the paper's
  warm/hot connection reuse.

* ``Topology`` / ``Link`` / ``Transfer`` / ``CongestionEngine`` — the
  shared-link contention layer (DESIGN.md §14).  A ``Topology`` maps
  endpoints onto per-endpoint NIC ports (full duplex: separate tx/rx
  links) plus an optional switch-core link (``oversubscribed`` preset);
  every in-flight ``Transfer`` occupies all links it crosses and
  concurrent transfers FAIR-SHARE each link's capacity: a transfer's
  rate is ``min(link bandwidth / transfers on link)`` over its path.
  Completion is progress-based on the VirtualClock — when any transfer
  starts or ends, every remaining transfer's finish time is
  re-integrated and the single completion event is rescheduled
  (deterministic, no wall-clock).  Channel sends consult the engine:
  with no transfer in flight they short-circuit to the closed-form
  ``latency + nbytes/bandwidth`` (bit-identical to the pre-congestion
  model); under load they are charged the fair-share rate observed at
  send time, and bulk sends register as load themselves.  Two 10 MB
  payloads fanning into one server no longer "overlap for free" — they
  share its NIC and each takes ~2x the solo time (paper §4 payload
  scaling, §6 parallel applications).

Delivery itself stays an in-process handoff (as in ``invocation.py``):
the *modeled* time is what flows into timelines and scenario stats, so
the same code path expresses rFaaS-over-RDMA and its TCP baselines by
swapping fabric parameters only.
"""
from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, replace
from typing import (Callable, Dict, FrozenSet, List, Optional,
                    Sequence, Set, Tuple, Union)

from repro_torch.core.clock import Clock, REAL_CLOCK
from repro_torch.core.perf_model import (NetParams, Sandbox, Tier,
                                   tier_overhead, write_time)

#: Modeled wire size of one control-plane message (lease request or
#: response, registration, availability delta) — a few header fields.
CONTROL_MSG_BYTES = 64
#: Modeled wire size of one heartbeat probe/ack.
HEARTBEAT_MSG_BYTES = 16

#: Per-channel wire counters, defined once (aggregators fold on these).
WIRE_COUNTERS = ("messages", "bytes", "drops", "blocked")


class ChannelError(RuntimeError):
    """Base class for transport faults surfaced to callers."""


class ChannelDropped(ChannelError):
    """A message was lost (injected drop).  On a reliable channel the
    loss is detected (retransmission timeout analogue) and surfaced so
    the caller can back off and retry."""


class ChannelPartitioned(ChannelError):
    """No route between the endpoints: the fabric is partitioned or the
    channel was closed."""


@dataclass(frozen=True)
class FabricParams:
    """One transport technology as a parameter set (Fig. 1: platforms
    differ only in these numbers, not in the code path)."""

    name: str
    net: NetParams
    connect_cost: float            # one-time connection setup (QP/handshake)
    encoding: float = 1.0          # wire expansion (4/3 = base64 payloads)
    reliable: bool = True          # RC verbs vs UD datagrams by default

    def message_time(self, nbytes: int) -> float:
        """Modeled one-way time of one message of ``nbytes`` payload."""
        if self.encoding == 1.0:         # hot path: no wire expansion
            return write_time(nbytes, self.net)
        return write_time(int(round(nbytes * self.encoding)), self.net)


def _rdma_params() -> FabricParams:
    net = NetParams()
    # connection setup = the paper's cold-breakdown "connect" step:
    # one RTT of QP exchange (2 one-way latencies)
    return FabricParams("rdma", net, connect_cost=2 * net.latency)


def _tcp_params() -> FabricParams:
    """rFaaS software stack over kernel TCP on 10 GbE: ~25 us one-way
    (syscall + stack traversal), ~1.15 GiB/s effective, no inline
    optimization, 3-way handshake at connect."""
    net = NetParams(latency=25e-6, bandwidth=1180 * 1024 ** 2,
                    inline_limit=0, inline_save=0.0)
    return FabricParams("tcp", net, connect_cost=3 * 25e-6)


def _nightcore_params() -> FabricParams:
    """nightcore as a fabric (Fig. 1's strongest baseline): microsecond
    dispatcher but TCP + JSON serialization.  Calibrated so a symmetric
    request/response round trip reproduces ``perf_model.nightcore_rtt``
    (190 us base + base64 payload at 450 MiB/s counted once per RTT):
    95 us one-way, 900 MiB/s per direction x 4/3 encoding.  Tier
    overheads are zero — nightcore has no busy-polling hot tier; its
    dispatcher cost lives in the wire latency."""
    net = NetParams(latency=95e-6, bandwidth=2 * 450 * 1024 ** 2,
                    inline_limit=0, inline_save=0.0,
                    hot_overhead=0.0, warm_overhead=0.0,
                    docker_hot_extra=0.0, docker_warm_extra=0.0,
                    cold_bare=100e-3, cold_docker=2.7)
    return FabricParams("nightcore", net, connect_cost=3 * 95e-6,
                        encoding=4.0 / 3.0)


def _local_params() -> FabricParams:
    """Same-host shared-memory handoff: ~100 ns, memcpy bandwidth."""
    net = NetParams(latency=100e-9, bandwidth=40 * 1024 ** 3,
                    inline_limit=0, inline_save=0.0)
    return FabricParams("local", net, connect_cost=0.0)


#: Named calibrated parameter sets; benchmarks select baselines by name.
FABRICS: Dict[str, FabricParams] = {
    "rdma": _rdma_params(),
    "tcp": _tcp_params(),
    "nightcore": _nightcore_params(),
    "local": _local_params(),
}


def fabric_params_for_net(net: NetParams,
                          name: str = "rdma") -> FabricParams:
    """Wrap a bare ``NetParams`` (legacy constructor argument) in fabric
    parameters with the rdma-style connection cost."""
    base = FABRICS.get(name, FABRICS["rdma"])
    if net == base.net:
        return base
    return replace(base, name=f"{name}*", net=net,
                   connect_cost=2 * net.latency)


# ---------------------------------------------------------------------------
# Topology + congestion layer (DESIGN.md §14)

class Link:
    """One shared capacity: a NIC port direction, a fat-tree pod uplink
    or the switch core.  ``active`` counts the transfers currently
    crossing it — fair-share rates divide ``bandwidth`` by this count.
    ``members`` is the insertion-ordered membership set (a dict keyed by
    Transfer) the incremental engine walks to find ONLY the transfers a
    start/finish actually affects; ``epoch`` bumps on every membership
    change so cached rates can tell whether their path moved at all
    (DESIGN.md §15)."""

    __slots__ = ("name", "bandwidth", "active", "bytes_total",
                 "peak_active", "members", "epoch", "wsum", "nonunit",
                 "shard")

    def __init__(self, name: str, bandwidth: float):
        self.name = name
        self.bandwidth = bandwidth          # bytes/s, math.inf = unconstrained
        self.active = 0
        # owning event shard (DESIGN.md §19): a link's membership is
        # only ever mutated from events stamped with this shard, so the
        # sharded driver never races two shards on one members dict.
        # Cross-shard transfers pin to the DESTINATION rx-NIC's shard;
        # shared pod/core links stay on shard 0.
        self.shard = 0
        self.bytes_total = 0
        self.peak_active = 0
        # dict-as-ordered-set: deterministic iteration (insertion
        # order), O(1) add/remove — a plain set would make completion
        # tie-breaking depend on id() hashes across runs
        self.members: Dict["Transfer", None] = {}
        self.epoch = 0
        # weighted fair share (DESIGN.md §18): sum of member weights and
        # the count of members whose weight differs from 1.0.  While
        # nonunit == 0 the share is computed from the INTEGER active
        # count — bit-identical to the pre-QoS 1/K division — so the
        # weighted machinery costs nothing until a weighted tenant
        # actually lands on the link.
        self.wsum = 0.0
        self.nonunit = 0

    def fair_share(self, extra: int = 0, weight: float = 1.0) -> float:
        """Per-transfer rate for a member of ``weight`` if
        ``active + extra`` transfers share the link: ``bw·w_i/Σw``,
        reducing to the exact integer-count ``bw/K`` when every weight
        on the link is 1 (the bit-identity anchor for all pre-QoS
        exact-value tests)."""
        if not self.nonunit and weight == 1.0:
            n = self.active + extra
            return self.bandwidth / n if n else self.bandwidth
        denom = self.wsum + extra * weight
        return self.bandwidth * weight / denom if denom \
            else self.bandwidth


class Topology:
    """Endpoint → NIC-port → shared-link map.

    Default shape: every endpoint owns a full-duplex NIC (separate tx
    and rx links, RDMA-style), all joined by a single non-blocking
    switch — the only contention points are the NICs themselves (the
    §4 fan-in regime: many clients writing into one server share its
    rx port).  ``oversubscribed`` adds a finite switch-core link whose
    capacity is ``nic_bandwidth * n_ports / ratio`` — the classic
    fat-tree tier where disjoint node pairs still contend.

    NIC links are minted lazily per endpoint, so the topology needs no
    advance knowledge of the cluster's endpoints (clients and replicas
    appear dynamically).  ``nic_bandwidth=None`` resolves to the owning
    fabric's calibrated link bandwidth at arm time, which is what makes
    the uncontended fast path bit-identical to the closed form."""

    def __init__(self, *, nic_bandwidth: Optional[float] = None,
                 core_bandwidth: Optional[float] = None,
                 min_track_bytes: int = 64 * 1024,
                 name: str = "single-switch"):
        self.name = name
        self.nic_bandwidth = nic_bandwidth
        self.core_bandwidth = core_bandwidth
        #: sends at or above this size register as link load themselves;
        #: smaller control messages are charged the fair share they see
        #: but add negligible load (they would distort counts at 64 B)
        self.min_track_bytes = min_track_bytes
        self._links: Dict[str, Link] = {}
        self.core: Optional[Link] = None
        self._oversub: Optional[Tuple[float, int]] = None  # (ratio, ports)
        # 2-tier fat tree (ratio, n_pods, ports_per_pod) + resolved
        # uplink capacity; None on single-switch/oversubscribed shapes
        self._fat: Optional[Tuple[float, int, int]] = None
        self._pod_bandwidth: Optional[float] = None
        self._pod_cache: Dict[str, int] = {}       # endpoint -> pod index
        # (src, dst) -> link tuple: paths are stable once links are
        # minted, and the charge path asks for the same pairs millions
        # of times in a storm replay
        self._path_cache: Dict[Tuple[str, str], Tuple[Link, ...]] = {}
        # endpoint -> shard map (DESIGN.md §19); None until a sharded
        # replay calls assign_shards
        self._shard_of: Optional[Callable[[str], int]] = None

    @classmethod
    def single_switch(cls, nic_bandwidth: Optional[float] = None,
                      **kw) -> "Topology":
        """Per-node NIC + non-blocking switch (the default fabric)."""
        return cls(nic_bandwidth=nic_bandwidth, **kw)

    @classmethod
    def oversubscribed(cls, ratio: float, n_ports: int,
                       nic_bandwidth: Optional[float] = None,
                       **kw) -> "Topology":
        """Switch core provisioned at ``n_ports / ratio`` NIC equivalents
        (ratio 1 = non-blocking, 4 = the common 4:1 uplink tier)."""
        if ratio <= 0 or n_ports <= 0:
            raise ValueError("oversubscription needs ratio > 0, ports > 0")
        topo = cls(nic_bandwidth=nic_bandwidth,
                   name=f"oversubscribed-{ratio:g}to1", **kw)
        topo._oversub = (ratio, n_ports)
        return topo

    @classmethod
    def fat_tree(cls, ratio: float, n_pods: int, ports_per_pod: int,
                 nic_bandwidth: Optional[float] = None,
                 **kw) -> "Topology":
        """2-tier fat tree: endpoints group into ``n_pods`` pods of
        ``ports_per_pod`` edge ports each; intra-pod traffic crosses
        only the NICs (non-blocking edge switch) while inter-pod
        traffic ALSO crosses the source pod's full-duplex uplink into
        the core and the destination pod's downlink out of it — each
        provisioned at ``ports_per_pod / ratio`` NIC equivalents (the
        multi-switch oversubscription tier; the core itself is
        non-blocking, as in a rearrangeably non-blocking fat tree).

        Node ids map onto pods by their numeric suffix
        (``node017`` → pod ``17 // ports_per_pod % n_pods``, so pods
        are contiguous node ranges); endpoints without one (clients,
        replicas, storm sources) hash deterministically."""
        if ratio <= 0 or n_pods < 2 or ports_per_pod <= 0:
            raise ValueError(
                "fat tree needs ratio > 0, n_pods >= 2, ports_per_pod > 0")
        topo = cls(nic_bandwidth=nic_bandwidth,
                   name=f"fat-tree-{ratio:g}to1-{n_pods}x{ports_per_pod}",
                   **kw)
        topo._fat = (ratio, n_pods, ports_per_pod)
        return topo

    def resolve(self, params: FabricParams):
        """Bind deferred capacities to the owning fabric's parameters."""
        if self.nic_bandwidth is None:
            self.nic_bandwidth = params.net.bandwidth
        if self._oversub is not None and self.core_bandwidth is None:
            ratio, ports = self._oversub
            self.core_bandwidth = self.nic_bandwidth * ports / ratio
        if self.core_bandwidth is not None and self.core is None:
            self.core = Link("core", self.core_bandwidth)
        if self._fat is not None and self._pod_bandwidth is None:
            ratio, _, ports_per_pod = self._fat
            self._pod_bandwidth = self.nic_bandwidth * ports_per_pod \
                / ratio

    # ------------------------------------------------------------ links
    def _nic(self, endpoint: str, direction: str) -> Link:
        key = f"{endpoint}/{direction}"
        link = self._links.get(key)
        if link is None:
            link = self._links[key] = Link(key, self.nic_bandwidth)
            if self._shard_of is not None:
                link.shard = self._shard_of(endpoint)
        return link

    def assign_shards(self, shard_of: Callable[[str], int]) -> None:
        """Pin every endpoint NIC link to the event shard owning that
        endpoint (DESIGN.md §19).  Already-minted NIC links are stamped
        now; links minted later pick the map up lazily in ``_nic``.
        Pod uplinks and the switch core are inherently cross-shard and
        stay pinned to shard 0 (their membership is only touched from
        transfer events, which pin to the destination's shard — the
        conservative lookahead window covers the skew)."""
        self._shard_of = shard_of
        for key, link in self._links.items():
            endpoint = key.rsplit("/", 1)[0]
            if not (endpoint.startswith("pod")
                    and endpoint[3:].isdigit()):
                link.shard = shard_of(endpoint)

    def pod_of(self, endpoint: str) -> int:
        """Deterministic endpoint → pod mapping (fat tree only)."""
        pod = self._pod_cache.get(endpoint)
        if pod is None:
            _, n_pods, ports_per_pod = self._fat
            digits = ""
            for c in reversed(endpoint):
                if c.isdigit():
                    digits = c + digits
                else:
                    break
            if digits:
                pod = (int(digits) // ports_per_pod) % n_pods
            else:
                import zlib
                pod = zlib.crc32(endpoint.encode()) % n_pods
            self._pod_cache[endpoint] = pod
        return pod

    def _pod_link(self, pod: int, direction: str) -> Link:
        key = f"pod{pod}/{direction}"
        link = self._links.get(key)
        if link is None:
            link = self._links[key] = Link(key, self._pod_bandwidth)
        return link

    def path(self, src: str, dst: str) -> Tuple[Link, ...]:
        """Links a src→dst transfer crosses: tx NIC, [pod uplinks |
        core], rx NIC.  Cached per (src, dst) — link objects are stable
        once minted."""
        p = self._path_cache.get((src, dst))
        if p is None:
            tx, rx = self._nic(src, "tx"), self._nic(dst, "rx")
            if self._fat is not None:
                ps, pd = self.pod_of(src), self.pod_of(dst)
                if ps == pd:
                    p = (tx, rx)
                else:
                    p = (tx, self._pod_link(ps, "up"),
                         self._pod_link(pd, "down"), rx)
            elif self.core is not None:
                p = (tx, self.core, rx)
            else:
                p = (tx, rx)
            self._path_cache[(src, dst)] = p
        return p

    def links(self) -> List[Link]:
        out = list(self._links.values())
        if self.core is not None:
            out.append(self.core)
        return out

    def nic_load(self, endpoint: str) -> int:
        """Transfers currently crossing this endpoint's NIC (tx + rx) —
        the utilization snapshot the placement layer ranks by."""
        load = 0
        for direction in ("tx", "rx"):
            link = self._links.get(f"{endpoint}/{direction}")
            if link is not None:
                load += link.active
        return load


class Transfer:
    """One in-flight bulk transfer occupying every link on its path.

    ``remaining`` drains at the fair-share ``rate``; integration is
    LAZY and per-transfer (``t_last`` marks the last instant progress
    was folded in), so a transfer untouched by a membership change
    costs nothing.  ``t_finish`` is the currently scheduled completion
    instant of this transfer's OWN clock event (``event``), rescheduled
    only when its rate actually moves.  After completion ``duration``
    holds the total modeled time (one-way latency + contended
    serialization)."""

    __slots__ = ("src", "dst", "nbytes", "path", "remaining", "rate",
                 "t_start", "t_last", "t_finish", "done", "duration",
                 "charged", "on_done", "event", "esig", "weight", "cap")

    def __init__(self, src: str, dst: str, nbytes: int,
                 path: Tuple[Link, ...], t_start: float,
                 on_done: Optional[Callable[["Transfer"], None]] = None,
                 weight: float = 1.0, cap: Optional[float] = None):
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.path = path
        self.remaining = float(nbytes)
        self.rate = 0.0
        self.t_start = t_start
        self.t_last = t_start
        self.t_finish = math.inf
        self.done = False
        self.duration: Optional[float] = None
        self.charged = False         # sync channel send: delay already
        self.on_done = on_done       # accounted at charge time
        self.event = None            # this transfer's completion event
        self.esig = -1               # path epoch signature of `rate`
        self.weight = weight         # tenant QoS share weight (§18)
        self.cap = cap               # tenant bandwidth cap, bytes/s


class CongestionEngine:
    """INCREMENTAL progress-based fair sharing of topology links on the
    clock (DESIGN.md §15).

    Every link keeps its membership set; when a transfer starts or
    finishes, the engine touches ONLY the transfers sharing a link with
    it: each one's progress since its own last touch is integrated at
    its previous rate, its new rate is ``min(bandwidth / active)`` over
    its path, and its private completion event is rescheduled (an O(1)
    cancel-and-rearm on the calendar clock) — but only when the rate
    actually moved, which the per-link epoch counters detect without
    recomputation.  A storm of T transfers fanning into K NICs costs
    O(degree) per membership change instead of the old global
    re-integration's O(T), turning storm replays from O(T²) into
    O(T·degree).  Everything remains a deterministic function of the
    start sequence — membership sets are insertion-ordered dicts, so
    same-instant completions tie-break identically on every run.

    Synchronous channel sends are *charged* the fair-share rate they
    observe at send time (integrated rates cannot be returned
    synchronously: a later arrival would retroactively slow them);
    sends at or above ``min_track_bytes`` also register as load so the
    contention they cause is felt by everyone else."""

    def __init__(self, topology: Topology, clock: Clock,
                 fabric: Optional["Fabric"] = None):
        self.topology = topology
        self.clock = clock
        self.fabric = fabric
        # one-way wire latency added to every completed transfer's
        # reported duration (the serialization phase alone occupies
        # links — latency is propagation, not capacity)
        self.latency = fabric.params.net.latency if fabric else 0.0
        # insertion-ordered live set (dict-as-set, O(1) removal)
        self._active: Dict[Transfer, None] = {}
        self._lock = threading.Lock()
        # whether solo transfers already deviate from the closed form
        # (custom NIC caps below the fabric's calibrated bandwidth)
        self.always_on = False
        # sharded event core (DESIGN.md §19): when True, each transfer's
        # completion event is stamped with its destination rx-NIC's
        # shard so the sharded queue routes it to the owning cursor
        self._sharded = False
        # telemetry (folded into Fabric.stats when armed)
        self.transfers_started = 0
        self.transfers_done = 0
        self.congested_sends = 0     # charges/transfers that shared a link
        self.congestion_delay_s = 0.0   # extra seconds vs solo closed form
        self.peak_link_active = 0
        self.cross_shard_transfers = 0   # tx shard != rx shard (§19)

    @property
    def active(self) -> bool:
        return bool(self._active)

    def active_transfers(self) -> List[Transfer]:
        with self._lock:
            return list(self._active)

    def solo_rate(self, path: Tuple[Link, ...]) -> float:
        return min(link.bandwidth for link in path)

    # ------------------------------------------------- incremental core
    def _schedule(self, tr: Transfer, now: float):
        """(Re)arm ``tr``'s completion event at its current finish
        time.  Caller holds the lock and has integrated ``tr`` to
        ``now``."""
        rate = tr.rate
        if rate <= 0.0:
            tr.t_finish = math.inf
            if tr.event is not None:
                tr.event.cancel()
                tr.event = None
            return
        if math.isinf(rate):
            tr.t_finish = now
        else:
            tr.t_finish = now + tr.remaining / rate
        if tr.event is None:
            if self._sharded:
                # pin the completion to the destination's shard; the
                # reschedule path below keeps a moved event's shard
                clk = self.clock
                prev = clk._shard_hint
                clk._shard_hint = tr.path[-1].shard
                tr.event = clk.call_at(tr.t_finish, self._fire, tr)
                clk._shard_hint = prev
            else:
                tr.event = self.clock.call_at(tr.t_finish, self._fire, tr)
        else:
            tr.event = self.clock.reschedule(tr.event, tr.t_finish)

    def _retire(self, tr: Transfer, now: float,
                finished: List[Transfer]) -> Dict[Transfer, None]:
        """Complete ``tr``, release its links and return the neighbors
        whose rates may now change.  Caller holds the lock."""
        tr.remaining = 0.0
        tr.done = True
        tr.duration = self.latency + (now - tr.t_start)
        if tr.event is not None:
            tr.event.cancel()
            tr.event = None
        affected: Dict[Transfer, None] = {}
        for link in tr.path:
            del link.members[tr]
            link.active -= 1
            link.epoch += 1
            link.wsum -= tr.weight
            if tr.weight != 1.0:
                link.nonunit -= 1
            for m in link.members:
                affected[m] = None
        del self._active[tr]
        self.transfers_done += 1
        if not tr.charged:
            solo = self.latency + (tr.nbytes / self.solo_rate(tr.path)
                                   if tr.nbytes else 0.0)
            extra = tr.duration - solo
            if extra > 1e-12:
                self.congested_sends += 1
                self.congestion_delay_s += extra
        finished.append(tr)
        return affected

    def _update_affected(self, affected: Dict[Transfer, None],
                         now: float, finished: List[Transfer]):
        """Re-rate the transfers that share a link with a membership
        change, lazily integrating each one's progress; transfers that
        turn out to have drained (their event was due at this very
        instant) retire in the same pass, cascading to THEIR
        neighbors.  Caller holds the lock."""
        while affected:
            cascade: Dict[Transfer, None] = {}
            for tr in affected:
                if tr.done:
                    continue
                path = tr.path
                esig = 0
                for link in path:
                    esig += link.epoch
                if esig == tr.esig:
                    continue         # epoch cache: path untouched
                dt = now - tr.t_last
                if dt > 0.0:
                    tr.remaining -= tr.rate * dt
                    if tr.remaining < 0.0:
                        tr.remaining = 0.0
                    tr.t_last = now
                # float-exact completions: the event was scheduled at
                # remaining/rate, so drained transfers sit at 0.0 (or a
                # hair above after an unrelated earlier event — treat
                # sub-byte residue at/past the finish instant as done)
                if tr.remaining <= 0.0 or (tr.t_finish <= now
                                           and tr.remaining < 1.0):
                    cascade.update(self._retire(tr, now, finished))
                    continue
                w = tr.weight
                rate = path[0].fair_share(0, w)
                for link in path:
                    r = link.fair_share(0, w)
                    if r < rate:
                        rate = r
                if tr.cap is not None and rate > tr.cap:
                    rate = tr.cap
                tr.esig = esig
                if rate != tr.rate:
                    tr.rate = rate
                    self._schedule(tr, now)
            affected = cascade       # retirements bumped epochs — loop
        if self.fabric is not None:
            self.fabric._cong_active = bool(self._active) \
                or self.always_on

    def _fire(self, tr: Transfer):
        """A transfer's own completion event: retire it and re-rate the
        neighbors that shared its links (any of which may drain at the
        same instant and cascade)."""
        finished: List[Transfer] = []
        with self._lock:
            if tr.done:
                return
            now = self.clock.now()
            dt = now - tr.t_last
            if dt > 0.0:
                tr.remaining -= tr.rate * dt
                if tr.remaining < 0.0:
                    tr.remaining = 0.0
                tr.t_last = now
            affected = self._retire(tr, now, finished)
            self._update_affected(affected, now, finished)
        for t in finished:
            if t.on_done is not None:
                t.on_done(t)

    # ------------------------------------------------------------ starts
    def start(self, src: str, dst: str, nbytes: int, *,
              on_done: Optional[Callable[["Transfer"], None]] = None,
              charged: bool = False, weight: float = 1.0,
              cap: Optional[float] = None) -> Transfer:
        """Register one transfer and re-rate ONLY the transfers sharing
        its links.  The transfer completes via its own clock event;
        ``on_done`` fires at that instant with the final ``duration``
        set.  ``weight``/``cap`` are the tenant's QoS parameters
        (§18): the transfer takes ``w_i/Σw`` of each link, never more
        than ``cap`` bytes/s."""
        finished: List[Transfer] = []
        with self._lock:
            now = self.clock.now()
            path = self.topology.path(src, dst)
            tr = self._start_locked(src, dst, nbytes, on_done, charged,
                                    now, path, finished, weight, cap)
        for t in finished:             # neighbors that drained at this
            if t.on_done is not None:  # exact instant
                t.on_done(t)
        return tr

    def _start_locked(self, src: str, dst: str, nbytes: int, on_done,
                      charged: bool, now: float,
                      path: Tuple[Link, ...],
                      finished: List[Transfer],
                      weight: float = 1.0,
                      cap: Optional[float] = None) -> Transfer:
        """Registration body; caller holds the lock and fires the
        ``finished`` callbacks after releasing it."""
        tr = Transfer(src, dst, nbytes, path, now, on_done, weight, cap)
        tr.charged = charged
        affected: Dict[Transfer, None] = {}
        peak = self.peak_link_active
        for link in path:
            for m in link.members:
                affected[m] = None
            link.members[tr] = None
            link.active += 1
            link.epoch += 1
            link.wsum += weight
            if weight != 1.0:
                link.nonunit += 1
            link.bytes_total += nbytes
            if link.active > link.peak_active:
                link.peak_active = link.active
            if link.active > peak:
                peak = link.active
        self.peak_link_active = peak
        self._active[tr] = None
        self.transfers_started += 1
        if self._sharded and path[0].shard != path[-1].shard:
            self.cross_shard_transfers += 1
        rate = path[0].fair_share(0, weight)
        esig = 0
        for link in path:
            r = link.fair_share(0, weight)
            if r < rate:
                rate = r
            esig += link.epoch
        if cap is not None and rate > cap:
            rate = cap
        tr.rate = rate
        tr.esig = esig
        self._schedule(tr, now)
        self._update_affected(affected, now, finished)
        return tr

    # ----------------------------------------------------------- charges
    def charged_time(self, src: str, dst: str, nbytes: int,
                     params: FabricParams, weight: float = 1.0,
                     cap: Optional[float] = None) -> float:
        """Congestion-aware modeled one-way time of a channel send:
        latency + serialization at the fair-share rate the transfer
        observes at send time (inline saving and wire encoding exactly
        as in the closed form — an uncontended charge reproduces
        ``FabricParams.message_time`` bit-identically).  Sends at or
        above ``min_track_bytes`` register as link load and drain via
        the engine; the charge itself stays synchronous because the
        invocation timeline needs the number at dispatch time.  Rates
        depend only on membership counts, so no integration happens
        here — the observation is O(path length)."""
        wire = nbytes if params.encoding == 1.0 \
            else int(round(nbytes * params.encoding))
        finished: List[Transfer] = []
        with self._lock:               # one critical section: rate
            # observation, congestion stats AND load registration
            path = self.topology.path(src, dst)
            rate = min(link.fair_share(1, weight) for link in path)
            if cap is not None and rate > cap:
                rate = cap
            solo = self.solo_rate(path)
            serial = wire / rate if wire else 0.0
            if rate < solo:
                self.congested_sends += 1
                self.congestion_delay_s += serial - wire / solo
            if wire >= self.topology.min_track_bytes:
                self._start_locked(src, dst, wire, None, True,
                                   self.clock.now(), path, finished,
                                   weight, cap)
        for tr in finished:            # neighbors drained at this instant
            if tr.on_done is not None:
                tr.on_done(tr)
        t = params.net.latency + serial
        if wire <= params.net.inline_limit:
            t -= params.net.inline_save
        return t if t > 0.0 else 0.0

    # ------------------------------------------------------------- stats
    def nic_load(self, endpoint: str) -> int:
        with self._lock:
            return self.topology.nic_load(endpoint)

    def stats(self) -> dict:
        with self._lock:
            out = {"topology": self.topology.name,
                   "transfers": self.transfers_started,
                   "transfers_done": self.transfers_done,
                   "congested": self.congested_sends,
                   "congestion_delay_s": self.congestion_delay_s,
                   "peak_link_active": self.peak_link_active}
            if self._sharded:     # key only appears on sharded replays
                out["cross_shard_transfers"] = self.cross_shard_transfers
            return out


class Channel:
    """Queue-pair analogue between two named endpoints.

    Reliable channels (RC) surface faults as exceptions; unreliable ones
    (UD) lose messages silently.  All modeled times come from the owning
    fabric's parameters; counters accumulate per channel so harnesses
    can audit exactly what crossed the wire."""

    __slots__ = ("fabric", "src", "dst", "reliable", "drop_rate",
                 "extra_delay", "connected_at", "messages", "bytes",
                 "drops", "blocked", "closed", "faulted", "_rng",
                 "_setup_pending", "_lock", "_mt_memo")

    def __init__(self, fabric: "Fabric", src: str, dst: str, *,
                 reliable: bool, drop_rate: float, extra_delay: float,
                 rng: random.Random):
        self.fabric = fabric
        self.src = src
        self.dst = dst
        self.reliable = reliable
        self.drop_rate = drop_rate
        self.extra_delay = extra_delay
        self.connected_at = fabric.clock.now()
        self.messages = 0
        self.bytes = 0
        self.drops = 0
        self.blocked = 0
        self.closed = False
        self.faulted = False             # closed because the route broke
        self._rng = rng
        self._setup_pending = fabric.params.connect_cost
        # per-channel lock: counters never contend across channels (the
        # per-message path must not serialize the whole cluster)
        self._lock = threading.Lock()
        # size -> params.message_time(size): workloads send the same
        # few sizes millions of times and the params are frozen —
        # shared fabric-wide so it survives channel churn
        self._mt_memo = fabric._size_memo

    # ------------------------------------------------------------ model
    @property
    def setup_cost(self) -> float:
        return self.fabric.params.connect_cost

    def take_setup(self) -> float:
        """Connection-setup cost, charged once: the first caller pays it,
        every later use of the cached channel is free — the paper's warm
        connection reuse made explicit (§3.3)."""
        with self._lock:                 # exactly-once even when two
            # grants race over the same cached control channel
            cost, self._setup_pending = self._setup_pending, 0.0
        return cost

    def message_time(self, nbytes: int) -> float:
        """Modeled one-way time for ``nbytes``, including any injected
        delay (fault surface for straggler scenarios).  Closed form —
        congestion-blind by design (estimates, lost-attempt costs)."""
        return self.fabric.params.message_time(nbytes) + self.extra_delay

    def _wire_time(self, nbytes: int, reverse: bool = False) -> float:
        """The authoritative modeled wire time of one delivered message:
        the closed form when no transfer is in flight anywhere, the
        congestion engine's fair-share charge when the fabric is loaded
        OR the message is bulk enough to register as load itself
        (the link path is direction-aware — a result return rides
        dst→src and contends with the CLIENT-side rx port)."""
        fabric = self.fabric
        if fabric._cong_active or nbytes >= fabric._cong_track_min:
            a, b = (self.dst, self.src) if reverse else (self.src, self.dst)
            if fabric._qos:
                weight, cap = fabric._qos_for(self.src, self.dst)
            else:
                weight, cap = 1.0, None
            return fabric.congestion.charged_time(
                a, b, nbytes, fabric.params, weight,
                cap) + self.extra_delay
        return fabric.params.message_time(nbytes) + self.extra_delay

    # ------------------------------------------------------------- wire
    def send(self, nbytes: int, reverse: bool = False) -> Optional[float]:
        """Model one message crossing the channel.

        Returns the modeled one-way time, or ``None`` when an unreliable
        channel lost the message.  Reliable channels raise
        ``ChannelPartitioned`` (no route / closed) or ``ChannelDropped``
        (injected loss) instead of silently failing.  ``reverse`` sends
        against the channel's orientation (dst→src: the result-return
        leg riding the client's queue pair), which matters under
        one-way partitions where only one direction is severed."""
        fabric = self.fabric
        if not (self.closed or self.drop_rate or fabric._partitions
                or fabric._down or fabric._cong_active
                or nbytes >= fabric._cong_track_min):
            # fast path — healthy channel, no faults armed anywhere and
            # no congestion in flight: identical arithmetic and counters
            # to the slow path below, minus the fault bookkeeping (this
            # is the 100k-invocation replay's innermost loop)
            t = self._mt_memo.get(nbytes)
            if t is None:
                t = self._mt_memo[nbytes] = \
                    fabric.params.message_time(nbytes)
            with self._lock:
                self.messages += 1
                self.bytes += nbytes
            return t + self.extra_delay
        a, b = (self.dst, self.src) if reverse else (self.src, self.dst)
        if self.closed or fabric.partitioned(a, b):
            with self._lock:
                self.blocked += 1        # keeps ch.stats() honest
            if self.closed:
                # counters were already folded away at close(): record
                # the event on the fabric directly too, so the
                # authoritative aggregate stays exact (per-client
                # transport_stats may miss teardown-racing blocks)
                with self.fabric._lock:
                    self.fabric._retired["blocked"] += 1
            if self.reliable:
                raise ChannelPartitioned(f"{a} -/-> {b}: no route")
            return None
        if self.drop_rate and self._rng.random() < self.drop_rate:
            with self._lock:
                self.drops += 1
            if self.reliable:
                raise ChannelDropped(
                    f"{self.src} -> {self.dst}: message lost")
            return None
        return self.transfer(nbytes, reverse=reverse)

    def send_retransmitting(self, nbytes: int, attempts: int = 3,
                            reverse: bool = False) -> float:
        """``send`` with the RC retransmission behaviour made explicit:
        injected losses are resent (each lost attempt still costs the
        modeled wire time).  A loss burst outlasting ``attempts``
        re-raises ``ChannelDropped`` — the RC retry-count-exceeded
        analogue, and the boundary where delivery degrades to
        at-least-once (the client re-executes elsewhere, §3.5).  Used
        for result returns, where the executor — not a client backoff
        loop — owns delivery."""
        t = 0.0
        for i in range(attempts):
            try:
                return t + (self.send(nbytes, reverse=reverse) or 0.0)
            except ChannelDropped:
                t += self.message_time(nbytes)   # lost attempt's wire time
                if i == attempts - 1:
                    raise
        return t

    def deliver_result(self, nbytes: int) -> float:
        """The result-return leg, policy owned by the channel: a
        GRACEFULLY closed channel (client teardown while the executor
        drains) still delivers — modeled time, no fault check, no
        counters; a faulted or partitioned one behaves like
        ``send_retransmitting`` and surfaces the broken route.  The
        result travels dst→src (the executor writing back over the
        client's queue pair), so the route check runs in REVERSE —
        under a one-way partition severing only the executor's side,
        dispatch still arrives but the result cannot come home."""
        fabric = self.fabric
        if not (self.closed or self.drop_rate or fabric._partitions
                or fabric._down or fabric._cong_active
                or nbytes >= fabric._cong_track_min):
            # healthy-route fast path, identical to send()'s
            t = self._mt_memo.get(nbytes)
            if t is None:
                t = self._mt_memo[nbytes] = \
                    fabric.params.message_time(nbytes)
            with self._lock:
                self.messages += 1
                self.bytes += nbytes
            return t + self.extra_delay
        if (self.closed and not self.faulted
                and not fabric.partitioned(self.dst, self.src)):
            # gracefully-closed channels (client teardown, failover to
            # another server) still deliver the in-flight result — and
            # that return leg rides the SAME links as live traffic, so
            # it is charged the congestion-aware wire time instead of
            # the old congestion-blind closed form (the ROADMAP's
            # "uncontended-path congestion for failed-over results")
            return self._wire_time(nbytes, reverse=True)
        return self.send_retransmitting(nbytes, reverse=True)

    def transfer(self, nbytes: int, reverse: bool = False) -> float:
        """A counted leg WITHOUT a fault check: used for the pieces of
        an exchange whose fate the caller already settled with ``send``
        — rpc responses, and the code push riding a negotiation that
        just succeeded.  Keeps counters equal to what actually crossed
        the wire; congestion-aware like every delivered message."""
        t = self._wire_time(nbytes, reverse=reverse)
        with self._lock:
            self.messages += 1
            self.bytes += nbytes
        return t

    def rpc(self, bytes_request: int,
            bytes_response: int = CONTROL_MSG_BYTES) -> float:
        """A request/response round trip with one fault check per
        direction — the unit of control-plane negotiation (lease
        requests, heartbeats).  Both legs hit the counters.  The
        response leg verifies the RETURN route separately: under a
        one-way partition the request may arrive while the reply
        cannot, and the caller must see that as a fault."""
        t = self.send(bytes_request)
        if t is None:                # unreliable rpc: loss = no reply
            return 0.0
        if self.fabric.partitioned(self.dst, self.src):
            with self._lock:
                self.blocked += 1
            if self.reliable:
                raise ChannelPartitioned(
                    f"{self.dst} -/-> {self.src}: no return route")
            return 0.0
        return t + self.transfer(bytes_response, reverse=True)

    def record_messages(self, n: int, nbytes_total: int):
        """Bulk counter update for ``n`` messages already modeled
        elsewhere (the cohort fast path charges a whole window of
        dispatch+result exchanges in one locked add).  Counter
        semantics are identical to ``n`` healthy ``send``s totalling
        ``nbytes_total`` — callers own the proof that every one of
        those sends would have taken the healthy fast path."""
        with self._lock:
            self.messages += n
            self.bytes += nbytes_total

    def close(self, faulted: bool = False):
        """Mark closed and hand the counters back to the fabric's
        retired totals, so long-churn runs don't accumulate channel
        objects (aggregate stats stay monotonic and O(live)).
        ``faulted`` records that the route broke (vs a graceful client
        teardown) — a faulted channel never delivers a late result,
        even after the fabric heals."""
        if faulted:
            self.faulted = True
        if not self.closed:
            self.closed = True
            self.fabric._retire(self)

    def fold_into(self, totals: dict):
        for key in WIRE_COUNTERS:
            totals[key] += getattr(self, key)

    def stats(self) -> dict:
        out = {"src": self.src, "dst": self.dst}
        for key in WIRE_COUNTERS:
            out[key] = getattr(self, key)
        return out


class Fabric:
    """Runtime transport instance: parameters + clock + fault state.

    One ``Fabric`` is shared by every component of a cluster (resource
    manager, executor managers, invokers, availability bus), so a single
    ``partition()`` call severs all traffic between two endpoint groups
    — control and data plane alike — and aggregate counters describe
    the whole cluster's wire activity."""

    def __init__(self, params: Union[str, FabricParams] = "rdma", *,
                 clock: Clock = REAL_CLOCK, seed: int = 0,
                 drop_rate: float = 0.0, extra_delay: float = 0.0,
                 topology: Optional[Topology] = None):
        if isinstance(params, str):
            params = FABRICS[params]
        self.params = params
        self.net = params.net
        self.clock = clock
        self.seed = seed
        self.drop_rate = drop_rate
        self.extra_delay = extra_delay
        # congestion layer: disarmed by default (per-message closed
        # form, the pre-topology model); armed fabrics keep the closed
        # form bit-identical whenever no transfer is in flight.
        # _cong_active is the hot-path flag the per-send check reads —
        # it flips True only while transfers occupy links (or a custom
        # topology constrains even solo transfers)
        self.congestion: Optional[CongestionEngine] = None
        self._cong_active = False
        # bulk-send threshold of the armed topology (inf when disarmed):
        # a send this large must engage the engine EVEN FROM IDLE so it
        # registers as link load — otherwise channel-only bulk traffic
        # would still overlap for free
        self._cong_track_min = math.inf
        # tenant QoS registry (DESIGN.md §18): endpoint -> (weight,
        # cap).  Empty for every pre-QoS scenario, and the charge path
        # checks emptiness before doing any lookup — unregistered
        # fabrics stay bit-identical to the unweighted engine.
        self._qos: Dict[str, Tuple[float, Optional[float]]] = {}
        # event-shard map (DESIGN.md §19): set by a sharded replay so
        # the armed topology pins links/completions to owning shards
        self._shard_map = None
        if topology is not None:
            self.arm_topology(topology)
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        # nbytes -> closed-form message_time: shared by ALL channels of
        # this fabric (params are frozen), so the memo survives channel
        # churn instead of re-warming per (client, worker) pair
        self._size_memo: Dict[int, float] = {}
        # (tier, sandbox) -> modeled overhead (per-completion lookup)
        self._ov_memo: Dict[tuple, float] = {}
        self._nchannels = 0
        self._channels: List[Channel] = []
        self._retired = {key: 0 for key in WIRE_COUNTERS}
        self._endpoints: Set[str] = set()
        # immutable snapshot, swapped atomically: the per-message
        # partitioned() check reads it without taking the fabric lock;
        # each entry is (group_a, group_b, one_way) — a one-way entry
        # only severs a→b
        self._partitions: Tuple[
            Tuple[FrozenSet[str], FrozenSet[str], bool], ...] = ()
        # crashed endpoints (a dead control-plane shard, DESIGN.md §20):
        # any route touching one is severed.  Deliberately SEPARATE from
        # _partitions so heal() — a network repair — cannot resurrect a
        # crashed process; same immutable-snapshot read discipline.
        self._down: FrozenSet[str] = frozenset()

    # ------------------------------------------------------- connections
    def _mk_channel(self, src: str, dst: str, *, reliable: bool,
                    drop_rate: Optional[float],
                    extra_delay: Optional[float]) -> Channel:
        with self._lock:
            self._nchannels += 1
            # per-channel RNG derived from (fabric seed, creation order):
            # fault decisions are reproducible per seed regardless of
            # which thread sends
            rng = random.Random((self.seed * 1_000_003 + self._nchannels)
                                & 0x7FFFFFFF)
            ch = Channel(self, src, dst, reliable=reliable,
                         drop_rate=self.drop_rate if drop_rate is None
                         else drop_rate,
                         extra_delay=self.extra_delay if extra_delay is None
                         else extra_delay, rng=rng)
            self._channels.append(ch)
            self._endpoints.add(src)
            self._endpoints.add(dst)
        return ch

    def connect(self, src: str, dst: str, *,
                drop_rate: Optional[float] = None,
                extra_delay: Optional[float] = None) -> Channel:
        """Open a reliable channel (RC queue pair analogue)."""
        return self._mk_channel(src, dst, reliable=True,
                                drop_rate=drop_rate,
                                extra_delay=extra_delay)

    def datagram(self, src: str, dst: str, *,
                 drop_rate: Optional[float] = None,
                 extra_delay: Optional[float] = None) -> Channel:
        """Open an unreliable channel (UD analogue): losses are silent."""
        return self._mk_channel(src, dst, reliable=False,
                                drop_rate=drop_rate,
                                extra_delay=extra_delay)

    def message_time(self, nbytes: int) -> float:
        return self.params.message_time(nbytes) + self.extra_delay

    def tier_overhead(self, tier: Tier, sandbox: Sandbox) -> float:
        """Memoized ``perf_model.tier_overhead`` against this fabric's
        calibrated parameters — one dict hit per completion instead of
        recomputing the branchy closed form."""
        memo = self._ov_memo
        v = memo.get((tier, sandbox))
        if v is None:
            v = memo[(tier, sandbox)] = tier_overhead(tier, sandbox,
                                                      self.net)
        return v

    # ------------------------------------------------------- congestion
    def arm_topology(self, topology: Topology) -> CongestionEngine:
        """Attach a shared-link topology: from here on, concurrent
        transfers fair-share NIC/core capacity and bulk channel sends
        are charged their contended rates.  Solo traffic on the default
        topology stays bit-identical to the closed form."""
        topology.resolve(self.params)
        self.congestion = CongestionEngine(topology, self.clock, self)
        self._cong_track_min = topology.min_track_bytes
        nic = topology.nic_bandwidth
        core = topology.core.bandwidth if topology.core else math.inf
        pod = topology._pod_bandwidth if topology._pod_bandwidth \
            is not None else math.inf
        # a solo transfer's rate is min(nic, core, pod uplink): if that
        # differs from the calibrated link bandwidth, the engine must
        # see EVERY send
        self.congestion.always_on = (
            min(nic, core, pod) != self.params.net.bandwidth)
        self._cong_active = self.congestion.always_on
        if self._shard_map is not None:
            self._apply_shard_map()
        return self.congestion

    def set_shard_map(self, shard_map) -> None:
        """Attach the event-shard map of a sharded replay (DESIGN.md
        §19): endpoint NIC links and transfer-completion events pin to
        the shard owning their endpoint.  Takes effect immediately on
        an armed topology and is re-applied if one is armed later.
        Sharding never changes rates or orderings — only which queue
        cursor pops each completion — so stats stay bit-identical."""
        self._shard_map = shard_map
        if self.congestion is not None:
            self._apply_shard_map()

    def _apply_shard_map(self) -> None:
        engine = self.congestion
        engine.topology.assign_shards(self._shard_map.shard_for_endpoint)
        # RealClock has no shard hint; pinning is a no-op there
        engine._sharded = hasattr(self.clock, "_shard_hint")

    def set_tenant_qos(self, endpoint: str, *, weight: float = 1.0,
                       cap: Optional[float] = None):
        """Register per-tenant network QoS (DESIGN.md §18): transfers
        and charged sends touching ``endpoint`` take ``weight·bw/Σw``
        of each shared link instead of the unweighted ``bw/K``, and
        never exceed ``cap`` bytes/s.  The defaults (weight 1, no cap)
        REMOVE the entry, so a fabric whose every tenant is standard
        keeps the exact pre-QoS arithmetic."""
        if weight <= 0.0 or not math.isfinite(weight):
            raise ValueError(f"weight must be finite and > 0, "
                             f"got {weight}")
        if cap is not None and cap <= 0.0:
            raise ValueError(f"cap must be > 0 bytes/s, got {cap}")
        with self._lock:
            if weight == 1.0 and cap is None:
                self._qos.pop(endpoint, None)
            else:
                self._qos[endpoint] = (weight, cap)

    def tenant_qos(self, endpoint: str) -> Tuple[float, Optional[float]]:
        return self._qos.get(endpoint, (1.0, None))

    def _qos_for(self, src: str,
                 dst: str) -> Tuple[float, Optional[float]]:
        """QoS parameters governing a src→dst message: the source
        endpoint's entry wins (the sender owns its traffic class);
        otherwise the destination's (a registered client's rx fan-in
        is shaped by its own class).  Reads are lock-free like
        ``partitioned()`` — entries are replaced atomically."""
        q = self._qos
        e = q.get(src)
        if e is None:
            e = q.get(dst)
        return e if e is not None else (1.0, None)

    def start_transfer(self, src: str, dst: str, nbytes: int, *,
                       on_done=None) -> Transfer:
        """Launch one bulk transfer on the topology (arming the default
        single-switch topology on first use).  The transfer fair-shares
        every link it crosses (weighted by the owning tenant's QoS
        entry, if any) and completes via a clock event; faults
        compose — a partitioned route refuses the transfer outright."""
        if self.congestion is None:
            self.arm_topology(Topology.single_switch())
        if self.partitioned(src, dst):
            raise ChannelPartitioned(f"{src} -/-> {dst}: no route")
        wire = nbytes if self.params.encoding == 1.0 \
            else int(round(nbytes * self.params.encoding))
        weight, cap = self._qos_for(src, dst) if self._qos \
            else (1.0, None)
        return self.congestion.start(src, dst, wire, on_done=on_done,
                                     weight=weight, cap=cap)

    def nic_load(self, endpoint: str) -> int:
        """Transfers currently crossing this endpoint's NIC — 0 when no
        topology is armed (the placement signal degrades gracefully)."""
        if self.congestion is None:
            return 0
        return self.congestion.nic_load(endpoint)

    def multicast(self, channels: Sequence[Channel],
                  nbytes: int) -> List[bool]:
        """One payload delivered to many unreliable channels — the
        §3.4 UD-multicast fan-out as a single fabric operation.  The
        payload is sized once (one memoized wire-time lookup) and each
        channel then pays only its own fate checks: per-channel seeded
        drop decisions draw from the same per-channel RNGs in the same
        order as N independent ``send``s, and every counter (messages,
        bytes, drops, blocked) lands exactly where a per-channel send
        loop would have put it — ``AvailabilityBus`` batching must be
        bit-invisible in the wire stats.  Returns one delivered flag
        per channel.  When partitions or congestion are live the
        fan-out degrades to true per-channel sends (route checks and
        fair-share charging are per-destination state)."""
        if not (self._partitions or self._down or self._cong_active
                or nbytes >= self._cong_track_min):
            t = self._size_memo.get(nbytes)
            if t is None:
                t = self._size_memo[nbytes] = \
                    self.params.message_time(nbytes)
            flags = []
            append = flags.append
            for ch in channels:
                if ch.closed:
                    with ch._lock:
                        ch.blocked += 1
                    with self._lock:
                        self._retired["blocked"] += 1
                    append(False)
                    continue
                if ch.drop_rate and ch._rng.random() < ch.drop_rate:
                    with ch._lock:
                        ch.drops += 1
                    append(False)
                    continue
                with ch._lock:
                    ch.messages += 1
                    ch.bytes += nbytes
                append(True)
            return flags
        flags = []
        for ch in channels:
            try:
                flags.append(ch.send(nbytes) is not None)
            except ChannelError:          # reliable channel in the set
                flags.append(False)
        return flags

    def endpoints(self) -> Set[str]:
        with self._lock:
            return set(self._endpoints)

    # ---------------------------------------------------------- faults
    def set_faults(self, *, drop_rate: Optional[float] = None,
                   extra_delay: Optional[float] = None,
                   existing_channels: bool = True):
        """Adjust fault injection; optionally retrofit open channels."""
        with self._lock:
            if drop_rate is not None:
                self.drop_rate = drop_rate
            if extra_delay is not None:
                self.extra_delay = extra_delay
            if existing_channels:
                for ch in self._channels:
                    if drop_rate is not None:
                        ch.drop_rate = drop_rate
                    if extra_delay is not None:
                        ch.extra_delay = extra_delay

    def partition(self, group_a, group_b, *, one_way: bool = False):
        """Sever connectivity between two endpoint groups until
        ``heal()``.  Symmetric by default; with ``one_way=True`` only
        the a→b direction is cut (asymmetric failure: group_a's
        messages vanish while group_b's still arrive).  Traffic within
        a group — e.g. a worker's result write to a client on the same
        side — still flows."""
        a, b = frozenset(group_a), frozenset(group_b)
        if a & b:
            raise ValueError(f"partition groups overlap: {sorted(a & b)}")
        with self._lock:
            self._partitions = self._partitions + ((a, b, one_way),)

    def heal(self):
        """Remove every active partition (one-way ones included).
        Downed endpoints stay down: healing the network does not
        resurrect a crashed process — use ``set_down(ep, False)``."""
        with self._lock:
            self._partitions = ()

    def set_down(self, endpoint: str, down: bool = True):
        """Mark an endpoint crashed (or recovered): every route
        touching a downed endpoint is severed in both directions, so
        reliable sends raise ``ChannelPartitioned`` and datagrams are
        blocked — the §3.5 process-failure surface for control-plane
        shards (DESIGN.md §20).  Unlike ``partition``, this survives
        ``heal()``."""
        with self._lock:
            if down:
                self._down = self._down | {endpoint}
            else:
                self._down = self._down - {endpoint}

    def partitioned(self, x: str, y: str) -> bool:
        """Is the DIRECTED route x→y severed?  (Symmetric partitions
        block both directions; one-way ones only a→b; a downed
        endpoint severs every route touching it.)"""
        down = self._down                        # atomic snapshot read
        if down and (x in down or y in down):
            return True
        for a, b, one_way in self._partitions:   # atomic snapshot read
            if x in a and y in b:
                return True
            if not one_way and x in b and y in a:
                return True
        return False

    # ------------------------------------------------------------ stats
    def _retire(self, ch: Channel):
        """Fold a closed channel's counters into the retired totals and
        drop the object (called from Channel.close())."""
        with self._lock:
            for key in WIRE_COUNTERS:
                self._retired[key] += getattr(ch, key)
            try:
                self._channels.remove(ch)
            except ValueError:
                pass                     # already retired

    def stats(self) -> dict:
        """Cumulative wire counters: every live channel plus everything
        already retired — monotonic across churn.  An armed topology
        adds its congestion telemetry (transfer counts, extra seconds
        paid to contention, peak link sharing)."""
        with self._lock:
            chans = list(self._channels)
            out = {"fabric": self.params.name, "channels": len(chans),
                   **self._retired}
        for ch in chans:
            ch.fold_into(out)
        if self.congestion is not None:
            out.update(self.congestion.stats())
        return out
