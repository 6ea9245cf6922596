"""Host-side request scheduling (the serving engine's admission layer).

Counterpart of ``repro.launch.engine.scheduler`` without the prefix
cache and the speculative-decode rollback, which are not ported yet.
``Request`` is the unit of work — a lifecycle state machine (``new ->
queued -> prefilling -> decoding -> finished``, with ``preempted``
re-entering at ``queued``) whose every edge goes through ONE audited
``transition`` method.  ``SlotScheduler`` maps queued requests onto fixed
decode slots through a ``policy.SchedPolicy`` and, on the paged KV
layout, owns the per-slot block tables over a ``block_pool.
BlockAllocator``: admission, on-demand decode grants (tables WIDEN when a
grant outruns them), and preemption when a grant cannot be covered.
Plain Python + numpy; device work is the engine's job.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.launch.engine.block_pool import BlockAllocator
from repro_torch.launch.engine.policy import FifoPolicy, SchedPolicy

# every legal edge of the request lifecycle; an illegal move raises
LIFECYCLE = {
    "new": ("queued",),
    "queued": ("prefilling",),
    "prefilling": ("decoding", "preempted"),
    "decoding": ("finished", "preempted"),
    "preempted": ("queued",),
    "finished": (),
}


@dataclasses.dataclass
class Request:
    """One serving request plus its accumulated results."""

    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    # priority class and SLO offset: carried for the stats' per-class
    # breakdown (the fifo policy does not rank by them)
    priority: int = 0
    slo_s: Optional[float] = None
    # engine step count at which this request joins the queue (0 = now)
    arrival_step: int = 0
    t_submit: float = 0.0
    t_finish: float = 0.0
    finish_reason: str = ""
    tokens: list = dataclasses.field(default_factory=list)
    H: list = dataclasses.field(default_factory=list)
    SE: list = dataclasses.field(default_factory=list)
    MI: list = dataclasses.field(default_factory=list)
    p_max: list = dataclasses.field(default_factory=list)
    epistemic_flags: int = 0
    aleatoric_flags: int = 0
    # the slot this request was (last) admitted into: operand-mode decode
    # noise keys the slot index, so equal streams need equal slots
    slot: Optional[int] = None
    state: str = "new"
    history: list = dataclasses.field(default_factory=list)
    queue_time_s: float = 0.0
    preempt_count: int = 0
    seq: int = -1
    _t_queued: float = dataclasses.field(default=0.0, repr=False)

    def transition(self, to: str, *, reason: str = "") -> None:
        """THE audited lifecycle edge: raises on an illegal move and
        applies the edge's side effects once (``queued`` stamps t_submit
        on first entry and opens the queue clock, ``prefilling`` closes
        it, ``preempted`` clears the output for a replay from the prompt,
        ``finished`` stamps t_finish / finish_reason)."""
        if to not in LIFECYCLE[self.state]:
            raise ValueError(
                f"request {self.rid}: illegal lifecycle transition "
                f"{self.state!r} -> {to!r} (legal: "
                f"{LIFECYCLE[self.state]})")
        now = time.perf_counter()
        if to == "queued":
            if self.state == "new":
                self.t_submit = now
            self._t_queued = now
        elif to == "prefilling":
            self.queue_time_s += now - self._t_queued
        elif to == "preempted":
            self.preempt_count += 1
            self.tokens.clear()
            for name in ("H", "SE", "MI", "p_max"):
                getattr(self, name).clear()
            self.epistemic_flags = 0
            self.aleatoric_flags = 0
        elif to == "finished":
            self.t_finish = now
            self.finish_reason = reason
        self.state = to
        self.history.append((to, now))

    @property
    def latency_s(self) -> float:
        return self.t_finish - self.t_submit

    @property
    def service_time_s(self) -> float:
        """Latency net of queue wait (prefill + decode + replays)."""
        return self.latency_s - self.queue_time_s


class SlotScheduler:
    """Policy-driven admission of queued requests into fixed decode slots.

    ``admit`` fills free slots in slot order with the request the
    ``policy`` selects; a request that cannot admit (no slot, or not
    enough pool) defers admission.  With a ``BlockAllocator`` admission
    needs the PROMPT's blocks plus a WATERMARK of free headroom
    (``num_slots`` blocks by default, waived when no slot is running) so
    running decoders keep growing; ``grant`` maps decode blocks on demand,
    capped at each request's ``prompt + max_new_tokens`` budget and
    WIDENING the tables when a grant outruns them; a grant the pool
    cannot cover returns None and the engine ``preempt``s the slot.
    """

    def __init__(self, num_slots: int,
                 allocator: Optional[BlockAllocator] = None,
                 table_width: int = 0, watermark: Optional[int] = None,
                 policy: Optional[SchedPolicy] = None):
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.allocator = allocator
        self.policy = policy if policy is not None else FifoPolicy()
        self.preemptions = 0
        self._seq = 0
        self.watermark = num_slots if watermark is None else watermark
        self.table_growths = 0
        if allocator is not None:
            if table_width < 1:
                raise ValueError("paged scheduling needs table_width "
                                 "(initial blocks per slot)")
            self.block_tables = np.full((num_slots, table_width), -1,
                                        np.int32)
            self._slot_blocks: list[list[int]] = \
                [[] for _ in range(num_slots)]
            # decode blocks still grantable per slot (a budget, not an
            # allocator reservation)
            self._slot_budget = [0] * num_slots
            # bumped on every table mutation so the engine re-uploads the
            # device table only when it changed
            self.table_version = 0

    def submit(self, req: Request) -> None:
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        req.transition("queued")
        self.queue.append(req)

    def _ensure_width(self, want: int) -> None:
        """Widen the host block tables to hold ``want`` blocks per slot
        (doubling, -1-padded)."""
        w = self.block_tables.shape[1]
        if want <= w:
            return
        grown = np.full((len(self.slots), max(want, 2 * w)), -1, np.int32)
        grown[:, :w] = self.block_tables
        self.block_tables = grown
        self.table_growths += 1
        self.table_version += 1

    def _try_reserve(self, need: int) -> bool:
        """Reserve ``need`` blocks for an admission, keeping ``watermark``
        blocks free for running slots' grants (waived when none runs)."""
        alloc = self.allocator
        wm = self.watermark if any(r is not None for r in self.slots) \
            else 0
        if alloc.available() < need + wm:
            return False
        return alloc.reserve(need)

    def _admit_paged(self, slot: int, qi: int) -> Optional[Request]:
        alloc = self.allocator
        req = self.queue[qi]
        P = len(req.prompt)
        nprompt = alloc.blocks_for(P)
        if not self._try_reserve(nprompt):
            return None                   # pool exhausted: defer
        del self.queue[qi]
        ids = alloc.alloc(nprompt)
        # grant cap, NOT a reservation: decode blocks come on demand
        self._slot_budget[slot] = alloc.blocks_for(P + req.max_new_tokens) \
            - nprompt
        self._slot_blocks[slot] = ids
        self._ensure_width(len(ids))
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :len(ids)] = ids
        self.table_version += 1
        return req

    def admit(self) -> list[tuple[int, Request]]:
        placed = []
        while self.queue:
            qi = self.policy.select(self.queue)
            if qi is None:
                break
            slot = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if slot is None:
                break
            if self.allocator is not None:
                req = self._admit_paged(slot, qi)
                if req is None:
                    break
            else:
                req = self.queue[qi]
                del self.queue[qi]
            req.slot = slot
            req.transition("prefilling")
            self.slots[slot] = req
            placed.append((slot, req))
        return placed

    def grant(self, slot: int, target_len: int) -> Optional[list[int]]:
        """Map blocks so slot ``slot`` can hold ``target_len`` tokens, up
        to its budget.  Returns the granted ids ([] when nothing is
        needed) or None when the pool cannot cover the shortfall."""
        alloc = self.allocator
        have = len(self._slot_blocks[slot])
        want = min(alloc.blocks_for(target_len),
                   have + self._slot_budget[slot])
        if want <= have:
            return []
        n = want - have
        if not alloc.reserve(n):
            return None
        ids = alloc.alloc(n)
        self._slot_budget[slot] -= n
        self._ensure_width(want)
        self.block_tables[slot, have:want] = ids
        self._slot_blocks[slot].extend(ids)
        self.table_version += 1
        return ids

    def preempt(self, slot: int) -> Request:
        """Evict a slot whose grant failed and requeue its request at the
        queue FRONT; the ``preempted`` transition clears its output and it
        restarts from the prompt."""
        req = self.evict(slot)
        req.transition("preempted")
        req.transition("queued")
        self.queue.appendleft(req)
        self.preemptions += 1
        return req

    def evict(self, slot: int) -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"evict of empty slot {slot}")
        self.slots[slot] = None
        if self.allocator is not None:
            self.allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._slot_budget[slot] = 0
            self.block_tables[slot, :] = -1
            self.table_version += 1
        return req

    def pool_stats(self) -> dict:
        """Queue depth + block-pool occupancy snapshot."""
        out = {"queue_depth": len(self.queue),
               "active_slots": sum(r is not None for r in self.slots)}
        if self.allocator is not None:
            a = self.allocator
            out.update(
                blocks_free=len(a._free), blocks_reserved=a._reserved,
                blocks_in_use=a.in_use,
                blocks_utilization=a.utilization(), blocks_cached=0)
        return out

    def mapped_blocks(self, slot: int) -> int:
        """Physical blocks mapped into the slot's table (what the decode
        kernel can read)."""
        return len(self._slot_blocks[slot])

    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
