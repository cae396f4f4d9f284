"""Replicated, eventually-consistent resource manager (paper §3.1, §3.4).

The manager never sits on the invocation path: it only (a) accepts node
registrations from the batch system via a REST-analogue call, (b) keeps a
heartbeat-verified availability registry of executor servers (ordering
policy lives with the clients — see Invoker's fabric-aware placement),
and (c) multicasts availability *deltas* to subscribed clients.  All of it rides the
transport fabric (DESIGN.md §12): registrations and heartbeat probes go
over reliable control channels — a partitioned node misses its
heartbeats and is evicted — while the multicast fans out over
unreliable-datagram channels whose seeded drop rate makes loss scenarios
reproducible.  Replicas gossip deltas asynchronously — eventual
consistency is sufficient because stale reads only shrink the visible
resource pool temporarily (paper §3.4), and the property test in
tests/test_core_properties.py verifies convergence.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.clock import Clock, REAL_CLOCK, ScheduledCall
from repro_torch.core.executor import ExecutorManager
from repro_torch.core.perf_model import DEFAULT_NET, NetParams
from repro_torch.core.transport import (Channel, ChannelDropped,
                                  ChannelPartitioned, CONTROL_MSG_BYTES,
                                  Fabric, HEARTBEAT_MSG_BYTES,
                                  fabric_params_for_net)


@dataclass
class ServerEntry:
    manager: ExecutorManager
    epoch: int = 0
    available: bool = True
    #: this replica's control channel to the server (heartbeat probes)
    channel: Optional[Channel] = field(default=None, repr=False)
    #: NIC utilization snapshot (in-flight transfers crossing the
    #: server's ports), refreshed by the heartbeat sweep — the
    #: congestion-aware placement signal (DESIGN.md §14).  Stale by up
    #: to one sweep interval, exactly like liveness itself.
    nic_load: int = 0


class AvailabilityBus:
    """Unreliable-datagram multicast analogue (§3.4): one UD channel per
    subscriber, modeled microsecond-scale latency, optional injected
    drop rate.  Losses are silent and tolerable for delta updates —
    clients catch up on the next delta.  Drop decisions draw from the
    fabric's seeded RNG, so loss patterns are reproducible per seed."""

    ENDPOINT = "rm:bus"

    def __init__(self, fabric: Optional[Fabric] = None,
                 drop_rate: float = 0.0, *, seed: int = 7):
        self.fabric = fabric if fabric is not None else Fabric(
            "rdma", seed=seed)
        self._drop_rate = drop_rate
        self._subs: List[Tuple[Callable[[dict], None], Channel]] = []
        self._lock = threading.Lock()
        self._sub_ids = itertools.count()    # labels never reused, even
        # after unsubscribes — endpoint-keyed faults must not alias
        #: batched fan-out (one Fabric.multicast op per publish) — the
        #: scalar per-subscriber send loop stays selectable so the
        #: equivalence test can prove batching is bit-invisible
        self.batched = True
        self.multicasts = 0
        self.delivered = 0
        self.dropped = 0

    @property
    def drop_rate(self) -> float:
        return self._drop_rate

    @drop_rate.setter
    def drop_rate(self, rate: float):
        """Assigning a new bus rate applies it to every live subscriber
        channel immediately; 0.0 means 'defer to the fabric-wide rate',
        exactly as it does at subscribe time.  Last writer wins between
        this and ``Fabric.set_faults`` — no hidden reconciliation."""
        with self._lock:
            self._drop_rate = rate
            for _, ch in self._subs:
                ch.drop_rate = rate if rate else self.fabric.drop_rate

    def subscribe(self, cb: Callable[[dict], None],
                  endpoint: Optional[str] = None):
        with self._lock:
            ep = endpoint or f"sub:{next(self._sub_ids)}"
            # a zero bus rate defers to the fabric-wide fault settings;
            # an explicit bus rate overrides them for delta traffic
            ch = self.fabric.datagram(self.ENDPOINT, ep,
                                      drop_rate=self._drop_rate or None)
            self._subs = self._subs + [(cb, ch)]   # replace, not mutate

    def unsubscribe(self, cb: Callable[[dict], None]):
        """Detach a subscriber and retire its datagram channel (churned
        clients must not leak fan-out work forever)."""
        with self._lock:
            keep = []
            for sub in self._subs:
                # == not `is`: bound methods are fresh objects per
                # attribute access but compare equal by (self, func)
                if sub[0] == cb:
                    sub[1].close()
                else:
                    keep.append(sub)
            self._subs = keep

    def publish(self, delta: dict):
        """Fan one delta out to every subscriber.  Batched mode (the
        default) serializes the delta once and hands the whole
        subscriber set to ``Fabric.multicast`` — one fan-out operation
        instead of N independent channel traversals, exactly the §3.4
        UD-multicast shape.  Per-subscriber seeded drop decisions,
        partition checks and wire counters are preserved bit-for-bit
        (each channel's own RNG is consulted in subscription order,
        precisely as the scalar loop does), and callbacks still fire in
        subscription order for every delivered copy."""
        with self._lock:
            subs = self._subs           # snapshot semantics preserved:
            # subscribe/unsubscribe REPLACE the list object (below), so
            # iterating the current reference is safe without a copy
            self.multicasts += 1
        delivered = dropped = 0
        if self.batched:
            if subs:
                flags = self.fabric.multicast([ch for _, ch in subs],
                                              CONTROL_MSG_BYTES)
                for (cb, _), ok in zip(subs, flags):
                    if not ok:
                        dropped += 1    # UD loss: clients catch up on
                        continue        # the next delta
                    delivered += 1
                    cb(delta)
        else:
            for cb, ch in subs:
                if ch.send(CONTROL_MSG_BYTES) is None:
                    dropped += 1
                    continue
                delivered += 1
                cb(delta)
        with self._lock:
            self.delivered += delivered
            self.dropped += dropped


class ResourceManagerReplica:
    def __init__(self, replica_id: int, bus: AvailabilityBus,
                 fabric: Optional[Fabric] = None):
        self.replica_id = replica_id
        self.bus = bus
        self.fabric = fabric if fabric is not None else bus.fabric
        self.endpoint = f"rm:{replica_id}"
        self._servers: Dict[str, ServerEntry] = {}
        self._lock = threading.RLock()
        self._peers: List["ResourceManagerReplica"] = []
        self._peer_channels: Dict[int, Channel] = {}
        self._epoch = 0
        # availability-list cache, versioned by registry mutations:
        # thousand-node clusters must not pay an O(n) rebuild per
        # allocation round when nothing changed
        self._list_version = 0
        self._list_cache: List[ExecutorManager] = []
        self._list_cache_version = -1
        # per-server NIC load snapshots, swapped atomically by the
        # heartbeat sweep; clients read the dict without a lock (the
        # reference swap is GIL-atomic and the dict is never mutated
        # after publication)
        self._nic_loads: Dict[str, int] = {}

    # ------------------------------------------------------- REST analogue
    def _server_channel(self, server_id: str) -> Channel:
        return self.fabric.connect(self.endpoint, server_id)

    def register(self, manager: ExecutorManager, propagate: bool = True):
        """Batch system releases a node for FaaS processing (§5.3); the
        registration message rides this replica's control channel."""
        with self._lock:
            self._epoch += 1
            self._list_version += 1
            old = self._servers.get(manager.server_id)
            entry = ServerEntry(manager, epoch=self._epoch,
                                channel=self._server_channel(
                                    manager.server_id))
            self._servers[manager.server_id] = entry
            manager.on_saturated = self._on_saturated
            manager.on_available = self._on_available
        if old is not None and old.channel is not None:
            old.channel.close()          # don't leak the stale channel
        try:
            entry.channel.send(CONTROL_MSG_BYTES)      # REST-analogue POST
        except (ChannelDropped, ChannelPartitioned):
            pass         # registration recorded; reachability is the
            # heartbeat sweep's problem, not the registration's
        if propagate:
            self._gossip({"op": "register", "server": manager,
                          "epoch": self._epoch})
            self.bus.publish({"op": "add", "server_id": manager.server_id})

    def remove(self, server_id: str, grace_s: float = 0.0,
               propagate: bool = True):
        """Single-step removal for batch-job priority (§5.3)."""
        with self._lock:
            entry = self._servers.pop(server_id, None)
            self._list_version += 1
        if entry is not None:
            if entry.channel is not None:
                entry.channel.close()
            entry.manager.retrieve(grace_s)
        if propagate:
            self._gossip({"op": "remove", "server_id": server_id})
            self.bus.publish({"op": "remove", "server_id": server_id})

    def known_server_ids(self) -> set:
        """Every registered server id, including saturated ones (which
        ``server_list`` hides from allocating clients)."""
        with self._lock:
            return set(self._servers)

    # -------------------------------------------------------------- client
    def server_list(self) -> List[ExecutorManager]:
        """Available executor servers.  The replica keeps an
        availability REGISTRY, not a ranking: every in-repo consumer
        permutes the list (decentralized contention-spreading, §3.2)
        and applies its own fabric-aware placement (Invoker), so
        ordering policy lives with the client.  The list is cached and
        rebuilt only when the registry mutates — a liveness filter is
        the only per-call work."""
        with self._lock:
            if self._list_cache_version != self._list_version:
                self._list_cache = [e.manager
                                    for e in self._servers.values()
                                    if e.available]
                self._list_cache_version = self._list_version
            cache = self._list_cache
        return [m for m in cache if m.heartbeat()]

    def nic_loads(self) -> Dict[str, int]:
        """Latest NIC-utilization snapshot (server_id → in-flight
        transfers on its ports), refreshed by the heartbeat sweep.
        Read-only view — the sweep publishes a fresh dict each time.
        Empty until a sweep runs or when no topology is armed, which
        degrades placement to the fault-memory-only ordering."""
        return self._nic_loads

    # ---------------------------------------------------------- saturation
    def _on_saturated(self, server_id: str):
        with self._lock:
            if server_id in self._servers:
                self._servers[server_id].available = False
                self._list_version += 1
        self._gossip({"op": "saturated", "server_id": server_id})
        self.bus.publish({"op": "saturated", "server_id": server_id})

    def _on_available(self, server_id: str):
        with self._lock:
            if server_id in self._servers:
                self._servers[server_id].available = True
                self._list_version += 1
        self._gossip({"op": "available", "server_id": server_id})
        self.bus.publish({"op": "add", "server_id": server_id})

    # ------------------------------------------------------------- gossip
    def connect_peers(self, peers: List["ResourceManagerReplica"]):
        self._peers = [p for p in peers if p is not self]
        self._peer_channels = {
            p.replica_id: self.fabric.connect(self.endpoint, p.endpoint)
            for p in self._peers}

    def _gossip(self, delta: dict):
        """Asynchronous delta propagation over replica-to-replica
        channels: a peer behind a partition or a lost datagram simply
        misses the delta — eventual consistency tolerates it (§3.4) and
        the next full delta catches it up."""
        for p in self._peers:
            ch = self._peer_channels.get(p.replica_id)
            if ch is not None:
                try:
                    ch.send(CONTROL_MSG_BYTES)
                except (ChannelDropped, ChannelPartitioned):
                    continue         # peer misses this delta
            p._apply(delta)

    def _apply(self, delta: dict):
        with self._lock:
            op = delta["op"]
            self._list_version += 1
            if op == "register":
                m = delta["server"]
                old = self._servers.get(m.server_id)
                if old is not None and old.channel is not None:
                    old.channel.close()
                self._servers[m.server_id] = ServerEntry(
                    m, epoch=delta["epoch"],
                    channel=self._server_channel(m.server_id))
            elif op == "remove":
                gone = self._servers.pop(delta["server_id"], None)
                if gone is not None and gone.channel is not None:
                    gone.channel.close()
            elif op == "saturated":
                if delta["server_id"] in self._servers:
                    self._servers[delta["server_id"]].available = False
            elif op == "available":
                if delta["server_id"] in self._servers:
                    self._servers[delta["server_id"]].available = True

    # ---------------------------------------------------------- heartbeats
    def sweep_heartbeats(self):
        """Periodic liveness check over the control fabric; dead OR
        unreachable (partitioned) servers are dropped (paper §3.1).  A
        single lost probe (injected drop) is a miss, not a death — the
        server survives until a sweep can actually reach it."""
        suspects = []
        with self._lock:
            entries = list(self._servers.items())
        fabric = self.fabric
        loads: Dict[str, int] = {}
        for sid, e in entries:
            alive = e.manager.heartbeat()
            if alive and e.channel is not None:
                try:
                    e.channel.rpc(HEARTBEAT_MSG_BYTES,
                                  HEARTBEAT_MSG_BYTES)
                except ChannelPartitioned:
                    alive = False              # unreachable == dead (§3.5)
                except ChannelDropped:
                    continue                   # missed beat: retry next sweep
            if not alive:
                suspects.append((sid, e))
            else:
                # the probe that proved the node reachable also samples
                # its NIC occupancy — the registry's congestion signal
                e.nic_load = loads[sid] = fabric.nic_load(sid)
        self._nic_loads = loads                # atomic snapshot swap
        dead = []
        evicted = []
        with self._lock:
            for sid, e in suspects:
                # evict only the entry we probed: a concurrent
                # re-registration replaced it with a live server and
                # must not be collateral damage
                if self._servers.get(sid) is e:
                    del self._servers[sid]
                    self._list_version += 1
                    dead.append(sid)
                    evicted.append(e)
                    if e.channel is not None:
                        e.channel.close()
        for e in evicted:
            # eviction reclaims the node's allocations, exactly like an
            # explicit remove(): active leases end RETRIEVED, billing
            # flushes and quota workers come home — otherwise a lease
            # on an unreachable node leaks and its tenant's QuotaState
            # is orphaned forever (chaos invariant 1/3, DESIGN.md §20).
            # Idempotent across replicas: Lease.end only fires once, so
            # the second replica's sweep of the same node is a no-op.
            e.manager.retrieve(0.0)
        for sid in dead:
            self._gossip({"op": "remove", "server_id": sid})
            self.bus.publish({"op": "remove", "server_id": sid})
        return dead


class ResourceManager:
    """Facade bundling replicas + bus; clients pick replicas at random
    (scalability via replication, §3.4)."""

    def __init__(self, n_replicas: int = 3,
                 net: NetParams = DEFAULT_NET, drop_rate: float = 0.0,
                 clock: Clock = REAL_CLOCK,
                 fabric: Optional[Fabric] = None, seed: int = 7):
        self.clock = clock
        # the cluster-wide transport fabric: replicas, bus, executor
        # managers and invokers all default to this instance, so one
        # partition() severs control and data plane together
        self.fabric = fabric if fabric is not None else Fabric(
            fabric_params_for_net(net), clock=clock, seed=seed)
        self.bus = AvailabilityBus(self.fabric, drop_rate, seed=seed)
        self.replicas = [ResourceManagerReplica(i, self.bus, self.fabric)
                         for i in range(n_replicas)]
        for r in self.replicas:
            r.connect_peers(self.replicas)
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_call: Optional[ScheduledCall] = None

    def primary(self) -> ResourceManagerReplica:
        return self.replicas[0]

    def replica_for(self, client_seed: int) -> ResourceManagerReplica:
        return self.replicas[client_seed % len(self.replicas)]

    def register(self, manager: ExecutorManager):
        self.primary().register(manager)

    def remove(self, server_id: str, grace_s: float = 0.0):
        self.primary().remove(server_id, grace_s)

    def consistently_known_ids(self) -> set:
        """Server ids every replica agrees on: a lossy fabric can leave
        one replica holding an eviction the others missed, and such a
        node must count as unknown so heal-time re-registration can
        repair the registry (``SimulatedCluster.heal``).  The sharded
        control plane implements the same protocol method over its
        alive shards (DESIGN.md §20)."""
        return set.intersection(*[r.known_server_ids()
                                  for r in self.replicas])

    def start_heartbeats(self, interval_s: float = 0.2):
        self.stop()                      # restart, don't leak a sweeper
        if self.clock.virtual:
            # recurring clock event instead of a thread: sweeps fire at
            # deterministic simulated instants
            def tick():
                for r in self.replicas:
                    r.sweep_heartbeats()
            self._hb_call = self.clock.call_repeating(interval_s, tick)
            return

        stop = self._hb_stop = threading.Event()   # fresh flag: the
        # previous thread keeps (and exits on) its own set event

        def loop():
            while not stop.wait(interval_s):
                for r in self.replicas:
                    r.sweep_heartbeats()
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def stop(self):
        self._hb_stop.set()
        if self._hb_call is not None:
            self._hb_call.cancel()
            self._hb_call = None
