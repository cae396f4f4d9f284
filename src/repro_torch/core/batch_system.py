"""Batch-system integration (paper §5.3): a SLURM-like cluster simulator
that releases idle nodes to the rFaaS resource manager and retrieves them
when batch jobs arrive.  Utilization traces with rapid availability churn
(the Piz Daint pattern of Fig. 2) drive the elasticity benchmarks.

The batch system is the PREEMPTION SOURCE of the whole reproduction:
batch jobs always outrank serverless tenants (§5.3 — rFaaS only soaks
up what the batch scheduler is not using), so starting a job reclaims
FaaS nodes mid-invocation, ending the leases RETRIEVED, and finishing a
job hands the nodes back through a fresh registration.  Three drivers
feed it:

* ``submit_job`` — an explicit SLURM-like submission into a priority
  queue; jobs start when enough nodes can be claimed (idle first, FaaS
  preempted next, in deterministic order) and completion is a scheduled
  clock event that re-releases the nodes and starts queued successors.
* ``apply_trace_event`` — ``core.trace`` replays recorded/synthetic
  churn (node_down/node_up/batch_job events) through the same claim and
  return paths, so a trace replay and an explicit job stream exercise
  identical code.
* ``churn_step`` — the original random-walk driver, kept for quick
  scenarios.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.accounting import Ledger
from repro_torch.core.clock import Clock, REAL_CLOCK
from repro_torch.core.executor import ExecutorManager
from repro_torch.core.resource_manager import ResourceManager


@dataclass
class Node:
    node_id: str
    n_workers: int
    memory_bytes: int
    state: str = "idle"               # idle | faas | batch
    manager: Optional[ExecutorManager] = None
    job_id: Optional[int] = None      # batch job currently holding it


@dataclass
class BatchJob:
    """One batch submission (§5.3).  Lower ``priority`` is more urgent;
    ties break by submission order, so scheduling is deterministic.
    ``affinity`` (when non-empty) restricts the job's claim — idle OR
    reclaim-from-FaaS — to exactly those node ids (SLURM's nodelist
    constraint); a job whose pinned nodes are busy is SKIPPED by the
    scheduler instead of blocking the queue head."""
    job_id: int
    n_nodes: int
    duration_s: float
    priority: int = 0
    grace_s: float = 0.0              # drain window for preempted leases
    t_submit: float = 0.0
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    state: str = "queued"             # queued | running | done
    nodes: List[str] = field(default_factory=list)
    affinity: tuple = ()              # () = any node

    def sort_key(self):
        return (self.priority, self.t_submit, self.job_id)


class BatchSystem:
    """Owns the node pool; idle nodes are registered as rFaaS executors
    (release), batch jobs preempt them back (retrieve)."""

    def __init__(self, rm: ResourceManager, ledger: Ledger,
                 n_nodes: int = 8, workers_per_node: int = 8,
                 memory_per_node: int = 8 << 30, *, sandbox: str = "bare",
                 hot_period: float = 1.0, fault_rate: float = 0.0,
                 seed: int = 0, clock: Clock = REAL_CLOCK):
        self.rm = rm
        self.ledger = ledger
        self.clock = clock
        self._rng = random.Random(seed)
        self.nodes: Dict[str, Node] = {
            f"node{i:03d}": Node(f"node{i:03d}", workers_per_node,
                                 memory_per_node)
            for i in range(n_nodes)
        }
        # incremental state tally: every transition goes through
        # _set_state, so occupancy reads are O(1) even at 1000 nodes
        # with trace replays querying per event.  The node-seconds
        # integrator lives HERE (not in the replayer) because states
        # also flip on clock events between trace events — job
        # completions, deferred starts — and integrating only at trace
        # instants would attribute those intervals to the wrong state.
        self._state_counts = {"idle": n_nodes, "faas": 0, "batch": 0}
        self._occ = {"idle": 0.0, "faas": 0.0, "batch": 0.0}
        self._occ_t = clock.now()
        # node managers join the resource manager's transport fabric so
        # cluster-wide partitions/faults cover their traffic too
        self._mk = dict(sandbox=sandbox, hot_period=hot_period,
                        fault_rate=fault_rate, clock=clock,
                        fabric=rm.fabric)
        # SLURM-analogue job machinery: priority heap of queued jobs,
        # running set, deterministic id sequence
        self._job_ids = itertools.count(1)
        self._queue: List[tuple] = []          # (sort_key, job)
        self.jobs: Dict[int, BatchJob] = {}
        # elasticity accounting (trace replays read these)
        self.preemptions = 0                   # FaaS nodes reclaimed
        self.node_returns = 0                  # nodes handed back to FaaS
        self.jobs_completed = 0

    # ----------------------------------------------------------- REST API
    def release_node(self, node_id: str) -> ExecutorManager:
        """Offer an idle node for serverless processing; the resource
        manager multicasts the new availability within microseconds."""
        node = self.nodes[node_id]
        assert node.state in ("idle", "faas")
        if node.manager is None or not node.manager.heartbeat():
            node.manager = ExecutorManager(
                node_id, node.n_workers, node.memory_bytes, self.ledger,
                seed=self._rng.randrange(1 << 30), **self._mk)
        else:
            node.manager.restore()     # retrieved earlier -> accept again
        self._set_state(node, "faas")
        self.rm.register(node.manager)
        return node.manager

    def release_idle(self) -> List[str]:
        out = []
        for nid, node in self.nodes.items():
            if node.state == "idle":
                self.release_node(nid)
                out.append(nid)
        return out

    def retrieve_node(self, node_id: str, grace_s: float = 0.0,
                      job_id: Optional[int] = None):
        """A batch job needs the node back: immediate (grace 0 — abort
        running invocations) or graceful drain (§5.3)."""
        node = self.nodes[node_id]
        if node.state == "faas":
            self.preemptions += 1
            self.rm.remove(node_id, grace_s)
            node.job_id = job_id
        elif node.state == "idle" or job_id is not None:
            node.job_id = job_id
        # else: a bare node_down on a node a RUNNING job holds keeps the
        # job's binding — clobbering it to None would make the job's
        # completion skip the node and leak it out of the pool forever
        self._set_state(node, "batch")

    def finish_batch_job(self, node_id: str):
        node = self.nodes[node_id]
        self._set_state(node, "idle")
        node.job_id = None

    def return_node(self, node_id: str) -> Optional[ExecutorManager]:
        """Batch work done: the node comes back to the FaaS pool through
        a fresh registration (trace node_up / job completion path)."""
        self.finish_batch_job(node_id)
        self.node_returns += 1
        return self.release_node(node_id)

    # -------------------------------------------------------- job queue
    def submit_job(self, n_nodes: int, duration_s: float, *,
                   priority: int = 0, grace_s: float = 0.0,
                   affinity=()) -> BatchJob:
        """SLURM-analogue submission: the job enters the priority queue
        and starts as soon as ``n_nodes`` can be claimed — idle nodes
        first, then FaaS nodes preempted in deterministic id order
        (batch always outranks serverless, §5.3).  ``affinity`` pins
        the claim to the named node ids (data locality / licensed
        hardware): only those nodes are reclaimed, and while they are
        held by another batch job the scheduler SKIPS this job
        deterministically instead of head-blocking the queue.
        Completion is a scheduled clock event that returns every node
        to the FaaS pool and starts queued successors."""
        affinity = tuple(sorted(affinity))
        unknown = set(affinity) - set(self.nodes)
        if unknown:
            raise ValueError(f"affinity names unknown nodes "
                             f"{sorted(unknown)}")
        if affinity and n_nodes > len(affinity):
            raise ValueError(
                f"job wants {n_nodes} nodes but its affinity only "
                f"names {len(affinity)}")
        job = BatchJob(next(self._job_ids), n_nodes, duration_s,
                       priority=priority, grace_s=grace_s,
                       t_submit=self.clock.now(), affinity=affinity)
        self.jobs[job.job_id] = job
        heapq.heappush(self._queue, (job.sort_key(), job))
        self._schedule()
        return job

    def _claimable(self, affinity: tuple = ()) -> List[str]:
        """Node ids a job may take, in claim order: idle first, then
        FaaS (preemption) — deterministic.  FaaS nodes are ranked by
        the protection of their most-protected hosted lease (spot-
        hosting nodes reclaimed FIRST, premium-hosting LAST, §18); the
        sort is stable, so a cluster whose every lease is standard
        keeps the exact pre-QoS node-id (or affinity) order.  A
        non-empty ``affinity`` restricts the pool to those node ids."""
        nodes = sorted(self.nodes.items()) if not affinity else \
            [(nid, self.nodes[nid]) for nid in affinity]
        idle = [nid for nid, n in nodes if n.state == "idle"]
        faas_nodes = [(nid, n) for nid, n in nodes if n.state == "faas"]
        ranks = {nid: (n.manager.hosted_protection()
                       if n.manager is not None else 1)
                 for nid, n in faas_nodes}
        faas = [nid for nid, _ in faas_nodes]
        if any(r != 1 for r in ranks.values()):
            faas.sort(key=ranks.__getitem__)   # stable: ties keep order
        return idle + faas

    def _schedule(self):
        """Start queued jobs while capacity (claimable nodes) lasts, in
        strict priority order.  An unconstrained job at the head blocks
        narrower lower-priority ones (no backfill — conservative SLURM
        semantics, and deterministic); an AFFINITY job whose pinned
        nodes are not claimable is skipped — it stays queued while jobs
        behind it start, because no amount of other capacity can
        satisfy it (§5.3 + per-job node affinity).  Each job preempts
        with ITS OWN grace window, whenever it ends up starting."""
        deferred: List[tuple] = []
        while self._queue:
            key, job = self._queue[0]
            if job.state != "queued":          # cancelled/defensive
                heapq.heappop(self._queue)
                continue
            avail = self._claimable(job.affinity)
            if len(avail) < job.n_nodes:
                if not job.affinity:
                    break                      # head job must wait
                heapq.heappop(self._queue)     # pinned + busy: skip it,
                deferred.append((key, job))    # the queue moves on
                continue
            heapq.heappop(self._queue)
            take = avail[:job.n_nodes]
            for nid in take:
                self.retrieve_node(nid, job.grace_s, job_id=job.job_id)
            job.nodes = take
            job.state = "running"
            job.t_start = self.clock.now()
            job.t_end = job.t_start + job.duration_s
            self.clock.call_later(job.duration_s, self._complete_job,
                                  job.job_id)
        for item in deferred:                  # skipped jobs keep their
            heapq.heappush(self._queue, item)  # place for the next pass

    def _complete_job(self, job_id: int):
        job = self.jobs.get(job_id)
        if job is None or job.state != "running":
            return
        job.state = "done"
        self.jobs_completed += 1
        for nid in job.nodes:
            if self.nodes[nid].job_id == job_id:
                self.return_node(nid)
        self._schedule()                       # successors may start now

    def queued_jobs(self) -> List[BatchJob]:
        return sorted((j for j in self.jobs.values()
                       if j.state == "queued"),
                      key=BatchJob.sort_key)

    # ------------------------------------------------------ trace driving
    def apply_trace_event(self, ev) -> bool:
        """Apply one ``core.trace`` churn event; returns True when the
        event touched this subsystem (transport fault events belong to
        the fabric and return False)."""
        kind = ev.kind
        if kind == "node_down":
            self.retrieve_node(ev.node_id, ev.grace_s)
            return True
        if kind == "node_up":
            node = self.nodes[ev.node_id]
            if node.state == "batch":
                self.return_node(ev.node_id)
            elif node.state == "idle":
                self.release_node(ev.node_id)
            return True
        if kind == "batch_job":
            self.submit_job(ev.n_nodes, ev.duration_s,
                            priority=ev.priority, grace_s=ev.grace_s,
                            affinity=ev.group_a)
            return True
        return False

    def churn_step(self, p_claim: float = 0.2, p_release: float = 0.3,
                   grace_s: float = 0.0) -> dict:
        """One step of a Piz-Daint-like availability random walk: batch
        jobs claim FaaS nodes with p_claim, finished jobs free nodes with
        p_release."""
        claimed, freed = [], []
        for nid, node in list(self.nodes.items()):
            if node.state == "faas" and self._rng.random() < p_claim:
                self.retrieve_node(nid, grace_s)
                claimed.append(nid)
            elif node.state == "batch" and self._rng.random() < p_release:
                self.finish_batch_job(nid)
                self.release_node(nid)
                freed.append(nid)
        return {"claimed": claimed, "freed": freed}

    def utilization(self) -> float:
        busy = sum(1 for n in self.nodes.values() if n.state == "batch")
        return busy / max(len(self.nodes), 1)

    def state_counts(self) -> Dict[str, int]:
        return dict(self._state_counts)

    def occupancy(self, up_to: Optional[float] = None) -> Dict[str, float]:
        """Node-seconds spent in each state, integrated exactly at
        every transition, up to ``up_to`` (default: now)."""
        self._integrate_occupancy(self.clock.now() if up_to is None
                                  else up_to)
        return dict(self._occ)

    def _integrate_occupancy(self, now: float):
        dt = now - self._occ_t
        if dt > 0:
            occ = self._occ
            for state, n in self._state_counts.items():
                occ[state] += n * dt
            self._occ_t = now

    def _set_state(self, node: Node, state: str):
        self._integrate_occupancy(self.clock.now())
        counts = self._state_counts
        counts[node.state] -= 1
        counts[state] += 1
        node.state = state
