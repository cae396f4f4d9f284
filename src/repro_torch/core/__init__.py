"""rFaaS core for the PyTorch port: the serving path's slice of the
simulator library, copied from the reference package.

Decentralized lease-based allocation, hot/warm/cold invocation tiers,
replicated eventually-consistent resource management, fault tolerance
with bounded retries + private executors, GB-s + compute-s accounting,
and the LogP-derived offload model (Eq. 1).  The modules are plain
Python and numpy; the only framework touch is the executor's wait on
CUDA results before it stops its clock.
"""
from repro_torch.core.accounting import (CLASS_PRICE_FACTOR, ClientBill,
                                         Ledger, Price, QuotaState)
from repro_torch.core.batch_system import BatchJob, BatchSystem, Node
from repro_torch.core.clock import (CalendarQueue, Clock, EVENT_QUEUES,
                                    HeapEventQueue, REAL_CLOCK, RealClock,
                                    ScheduledCall, VirtualClock)
from repro_torch.core.executor import (AllocationRejected, ExecutorCrash,
                                       ExecutorManager, ExecutorProcess,
                                       ExecutorWorker)
from repro_torch.core.functions import FunctionLibrary
from repro_torch.core.invocation import (Invocation, InvocationHeader,
                                         RFuture, Timeline, payload_bytes)
from repro_torch.core.invoker import (ALWAYS_WARM_INVOCATIONS,
                                      AllocationFailed, CLASS_NET_WEIGHT,
                                      CLASS_NIC_HEADROOM, Connection, Invoker,
                                      RetryingFuture)
from repro_torch.core.lease import (CLASS_PROTECTION, LEASE_CLASSES, Lease,
                                    LeaseRequest, LeaseState,
                                    TERMINAL_STATES)
from repro_torch.core.perf_model import (BASELINE_MODELS, DEFAULT_NET,
                                         NetParams, Sandbox, Tier,
                                         invocation_rtt, max_offload_rate,
                                         n_local_min, plan_split,
                                         tier_overhead, write_time)
from repro_torch.core.resource_manager import (AvailabilityBus,
                                               ResourceManager,
                                               ResourceManagerReplica)
from repro_torch.core.transport import (Channel, ChannelDropped,
                                        ChannelError, ChannelPartitioned,
                                        CONTROL_MSG_BYTES, CongestionEngine,
                                        FABRICS, Fabric, FabricParams,
                                        HEARTBEAT_MSG_BYTES, Link, Topology,
                                        Transfer)

__all__ = [
    "CLASS_PRICE_FACTOR", "ClientBill", "Ledger", "Price", "QuotaState",
    "BatchJob", "BatchSystem", "Node",
    "CalendarQueue", "Clock", "EVENT_QUEUES", "HeapEventQueue",
    "REAL_CLOCK", "RealClock", "ScheduledCall", "VirtualClock",
    "AllocationRejected", "ExecutorCrash", "ExecutorManager",
    "ExecutorProcess", "ExecutorWorker", "FunctionLibrary", "Invocation",
    "InvocationHeader", "RFuture", "Timeline", "payload_bytes",
    "ALWAYS_WARM_INVOCATIONS", "AllocationFailed", "CLASS_NET_WEIGHT",
    "CLASS_NIC_HEADROOM", "Connection", "Invoker", "RetryingFuture",
    "CLASS_PROTECTION", "LEASE_CLASSES", "Lease", "LeaseRequest",
    "LeaseState", "TERMINAL_STATES", "BASELINE_MODELS", "DEFAULT_NET",
    "NetParams", "Sandbox", "Tier", "invocation_rtt", "max_offload_rate",
    "n_local_min", "plan_split", "tier_overhead", "write_time",
    "AvailabilityBus", "ResourceManager", "ResourceManagerReplica",
    "Channel", "ChannelDropped", "ChannelError", "ChannelPartitioned",
    "CONTROL_MSG_BYTES", "CongestionEngine", "FABRICS", "Fabric",
    "FabricParams", "HEARTBEAT_MSG_BYTES", "Link", "Topology", "Transfer",
]
