"""Layered serving-engine package (PyTorch counterpart of
``repro.launch.engine``), one layer per module:

  engine.py     -- ServeEngine: serving policy + the per-chunk loop
  scheduler.py  -- Request lifecycle / SlotScheduler (admission through
                   the prefix cache, grants, rollback, preemption, block
                   tables; numpy only)
  policy.py     -- SchedPolicy: the admission / eviction decision layer
                   (fifo, priority classes + SLO deadlines + preemption)
  escalate.py   -- EscalationLane: the high-S OOD verification sidecar
  block_pool.py -- BlockAllocator: refcounted KV block accounting
  runner.py     -- ModelRunner: ALL device placement and dispatch
  stats.py      -- ServeStats: run counters + the results payload
"""

from repro_torch.launch.engine.block_pool import BlockAllocator
from repro_torch.launch.engine.engine import ServeEngine
from repro_torch.launch.engine.escalate import EscalationLane
from repro_torch.launch.engine.policy import (FifoPolicy, PriorityPolicy,
                                              SchedPolicy, get_policy)
from repro_torch.launch.engine.runner import ModelRunner
from repro_torch.launch.engine.scheduler import (LIFECYCLE, PrefixAdmit,
                                                 Request, SlotScheduler)
from repro_torch.launch.engine.stats import ServeStats

__all__ = [
    "BlockAllocator", "EscalationLane", "FifoPolicy", "LIFECYCLE",
    "ModelRunner", "PrefixAdmit", "PriorityPolicy", "Request", "SchedPolicy",
    "ServeEngine", "ServeStats", "SlotScheduler", "get_policy",
]
