"""Analytical invocation-performance model (paper §4, LogP/LogfP-derived).

The network parameters are calibrated to the paper's testbed (Mellanox
MT27800 100 Gb/s RoCEv2: RTT 3.69 us, 11 686.4 MiB/s, 128 B inline limit)
and the measured rFaaS overheads (hot +326 ns, warm +4.67 us, Docker
+50 ns / +650 ns, cold 25 ms bare / 2.7 s Docker).  On this CPU-only
container the network is *modeled* with these constants while compute and
control-plane overheads are *measured* — DESIGN.md §11 records this
boundary.  The same module provides the latency models of the baseline
platforms (AWS Lambda / OpenWhisk / nightcore) used by the Fig.-1
benchmark, calibrated so the paper's reported speedup ranges
(695–3692x / 5904–22406x / 17–28x) are reproduced.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum


class Tier(Enum):
    COLD = "cold"
    WARM = "warm"
    HOT = "hot"


class Sandbox(Enum):
    BARE = "bare"
    DOCKER = "docker"


@dataclass(frozen=True)
class NetParams:
    # LogfP-style parameters of the RDMA fabric
    latency: float = 1.845e-6          # one-way wire latency (RTT/2)
    bandwidth: float = 11686.4 * 1024 ** 2   # bytes/s (measured link)
    inline_limit: int = 128            # max WQE-inlined message bytes
    inline_save: float = 0.30e-6       # saved DMA fetch for inlined sends
    header_bytes: int = 12             # invocation header (fn idx, id, rkey)

    # measured rFaaS invocation overheads (paper §6.1)
    hot_overhead: float = 326e-9
    warm_overhead: float = 4.67e-6
    docker_hot_extra: float = 50e-9
    docker_warm_extra: float = 650e-9

    # cold-start (paper §6.2; dominated by worker creation)
    cold_bare: float = 25e-3
    cold_docker: float = 2.7


DEFAULT_NET = NetParams()


def write_time(nbytes: int, p: NetParams = DEFAULT_NET) -> float:
    """One RDMA write of nbytes: latency + serialization, minus the inline
    saving when the payload fits the WQE (paper §6.1 observes the 128 B
    asymmetry: header pushes the input over the limit)."""
    t = p.latency + nbytes / p.bandwidth
    if nbytes <= p.inline_limit:
        t -= p.inline_save
    return t if t > 0.0 else 0.0


def tier_overhead(tier: Tier, sandbox: Sandbox,
                  p: NetParams = DEFAULT_NET) -> float:
    if tier == Tier.HOT:
        o = p.hot_overhead
        if sandbox == Sandbox.DOCKER:
            o += p.docker_hot_extra
        return o
    if tier == Tier.WARM:
        o = p.warm_overhead
        if sandbox == Sandbox.DOCKER:
            o += p.docker_warm_extra
        return o
    return p.cold_docker if sandbox == Sandbox.DOCKER else p.cold_bare


def invocation_rtt(bytes_in: int, bytes_out: int, tier: Tier,
                   sandbox: Sandbox, exec_time: float,
                   p: NetParams = DEFAULT_NET) -> float:
    """Modeled round trip: header+payload write in, result write back,
    plus the tier overhead and the function execution itself."""
    net = write_time(bytes_in + p.header_bytes, p) + write_time(bytes_out, p)
    return net + tier_overhead(tier, sandbox, p) + exec_time


# ---------------------------------------------------------------------------
# Eq. 1 (paper §4): offloading is safe iff N_local·T_local >= T_inv + L


def n_local_min(t_local: float, t_inv: float, rtt: float) -> int:
    """Minimum number of locally-kept tasks that hides one remote
    invocation (Eq. 1 solved for N_local)."""
    if t_local <= 0:
        return 0
    return max(0, math.ceil((t_inv + rtt) / t_local))


def max_offload_rate(bytes_per_inv: int,
                     p: NetParams = DEFAULT_NET) -> float:
    """N_remote: invocations/second that saturate the link (paper §4)."""
    return p.bandwidth / max(bytes_per_inv, 1)


def plan_split(n_tasks: int, t_local: float, t_inv: float,
               bytes_in: int, bytes_out: int, n_remote_workers: int,
               p: NetParams = DEFAULT_NET) -> dict:
    """Choose (n_local, n_remote) minimizing the makespan under the model:
    local time = n_l·t_local; remote time = RTT + serialization-limited
    pipeline over n_remote_workers.  The paper's guiding principle — the
    application never waits for remote invocations — corresponds to
    remote_time <= local_time."""
    rtt = write_time(bytes_in + p.header_bytes, p) + write_time(bytes_out, p)
    per_task_remote = max(t_inv / max(n_remote_workers, 1),
                          (bytes_in + bytes_out) / p.bandwidth)
    best = (float("inf"), n_tasks, 0)
    for n_r in range(0, n_tasks + 1):
        n_l = n_tasks - n_r
        remote = (rtt + n_r * per_task_remote) if n_r else 0.0
        makespan = max(n_l * t_local, remote)
        if makespan < best[0]:
            best = (makespan, n_l, n_r)
    makespan, n_l, n_r = best
    return {"n_local": n_l, "n_remote": n_r, "makespan": makespan,
            "speedup": (n_tasks * t_local) / makespan if makespan else 1.0,
            "rtt": rtt}


# ---------------------------------------------------------------------------
# Baseline FaaS platforms (Fig. 1 comparison), calibrated to the paper's
# reported speedup ranges over the same payload sweep.

_B64 = 4.0 / 3.0    # other platforms require base64-encoded payloads


def lambda_rtt(nbytes: int, exec_time: float = 0.0) -> float:
    """AWS Lambda: dedicated per-invocation placement service + HTTP
    gateway (~5 ms) and slow payload path (~2 MiB/s effective with
    base64).  695x @1 kB … 3692x @5 MB vs rFaaS."""
    return 5e-3 + (_B64 * nbytes) / (2.1 * 1024 ** 2) + exec_time


def openwhisk_rtt(nbytes: int, exec_time: float = 0.0) -> float:
    """OpenWhisk: controller + Kafka + load balancer + Docker pause/resume
    on the critical path (~120 ms) and argv/JSON payload path (~1 MiB/s).
    5904x–22406x vs rFaaS."""
    return 120e-3 + (_B64 * nbytes) / (1.0 * 1024 ** 2) + exec_time


def nightcore_rtt(nbytes: int, exec_time: float = 0.0) -> float:
    """nightcore: microsecond-scale dispatcher but TCP + JSON
    serialization (~190 us base, ~450 MiB/s).  17x–28x vs rFaaS."""
    return 190e-6 + (_B64 * nbytes) / (450 * 1024 ** 2) + exec_time


def funcx_rtt(nbytes: int, exec_time: float = 0.0) -> float:
    """FuncX (related work §7): federated hierarchy, >=90 ms warm."""
    return 90e-3 + (_B64 * nbytes) / (50 * 1024 ** 2) + exec_time


BASELINE_MODELS = {
    "aws_lambda": lambda_rtt,
    "openwhisk": openwhisk_rtt,
    "nightcore": nightcore_rtt,
    "funcx": funcx_rtt,
}
