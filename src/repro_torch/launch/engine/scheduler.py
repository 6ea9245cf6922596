"""Host-side request scheduling (the serving engine's admission layer).

Counterpart of ``repro.launch.engine.scheduler``.  ``Request`` is the unit
of work — a lifecycle state machine (``new -> queued -> prefilling ->
decoding -> finished``, with ``preempted`` re-entering at ``queued`` and
``escalated`` finishing on the high-S lane) whose every edge goes through
ONE audited ``transition`` method.  ``SlotScheduler`` maps queued requests
onto fixed decode slots through a ``policy.SchedPolicy`` (fifo, the
reference; priority adds classes, SLO deadlines and preemption at
admission) and, on the paged KV layout, owns the per-slot block tables
over a ``block_pool.BlockAllocator``: admission (through the radix prefix
cache when there is one), on-demand decode grants (tables WIDEN when a
grant outruns them), speculative-round rollback, LRU eviction of cached
blocks under pool pressure, and preemption when a grant cannot be
covered.  Plain Python + numpy; device work (prefill, CoW copies, table
uploads) is the engine's job, driven by the records this layer produces.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.launch.engine.block_pool import BlockAllocator
from repro_torch.launch.engine.policy import FifoPolicy, SchedPolicy

# the one clock every lifecycle stamp reads (``Request.transition``): a
# seam, so that a test can skew one rank's clock.  Under a mesh the
# engine replaces each new request's ``t_submit`` with rank 0's
# (``ServeEngine._run``), so every rank ranks SLO deadlines alike.
clock = time.perf_counter

# every legal edge of the request lifecycle; an illegal move raises
LIFECYCLE = {
    "new": ("queued",),
    "queued": ("prefilling",),
    "prefilling": ("decoding", "preempted"),
    "decoding": ("finished", "preempted", "escalated"),
    "preempted": ("queued",),
    "escalated": ("finished",),
    "finished": (),
}


@dataclasses.dataclass
class Request:
    """One serving request plus its accumulated results."""

    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    # priority CLASS (lower value = better class; 0 is the best) and an
    # optional SLO deadline offset: only the priority policy reads them
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
    # MI of the most recently harvested token; speculative rounds gate on
    # it (only slots with last_mi strictly below the spec threshold
    # draft).  +inf until the first token lands
    last_mi: float = float("inf")
    # the slot this request was (last) admitted into: operand-mode decode
    # noise keys the slot index, so equal streams need equal slots
    slot: Optional[int] = None
    state: str = "new"
    history: list = dataclasses.field(default_factory=list)
    queue_time_s: float = 0.0
    preempt_count: int = 0
    seq: int = -1
    # adaptive speculative draft depth: the slot's current k and the
    # acceptance-rate EMA driving it (engine-owned, reset on preempt)
    spec_k_cur: int = 0
    spec_ema: Optional[float] = None
    _t_queued: float = dataclasses.field(default=0.0, repr=False)

    def transition(self, to: str, *, reason: str = "") -> None:
        """THE audited lifecycle edge: raises on an illegal move and
        applies the edge's side effects once (``queued`` stamps t_submit
        on first entry and opens the queue clock, ``prefilling`` closes
        it, ``preempted`` clears the output for a replay from the prompt,
        ``finished`` stamps t_finish / finish_reason; ``preempted`` also
        resets the carried MI and the spec-decode depth)."""
        if to not in LIFECYCLE[self.state]:
            raise ValueError(
                f"request {self.rid}: illegal lifecycle transition "
                f"{self.state!r} -> {to!r} (legal: "
                f"{LIFECYCLE[self.state]})")
        now = clock()
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
            self.last_mi = float("inf")
            self.spec_k_cur = 0
            self.spec_ema = None
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

    @property
    def was_escalated(self) -> bool:
        return any(s == "escalated" for s, _ in self.history)


@dataclasses.dataclass
class PrefixAdmit:
    """Per-slot prefix-cache admission record the engine acts on.

    ``tokens`` of the prompt are already resident in shared blocks mapped
    read-only into the slot's table; prefill runs only on the suffix.
    ``cow`` is a pending ``(src, dst)`` device-side block copy: the
    partially matched tail block ``src`` stays referenced until the engine
    copies it into ``dst`` (already swapped into the table) and calls
    ``finish_cow``.
    """

    tokens: int
    cow: Optional[tuple] = None


class SlotScheduler:
    """Policy-driven admission of queued requests into fixed decode slots.

    ``admit`` fills free slots in slot order with the request the
    ``policy`` selects.  When the selected request cannot admit (no free
    slot, or not enough pool) the policy may name a DECODING slot of a
    strictly worse class to preempt on its behalf (fifo never does), else
    admission defers; the slots preempted inside ``admit`` are surfaced
    by ``take_preempted`` so the engine can deactivate them before it
    acts on the new placements.  With a ``BlockAllocator`` admission
    needs the PROMPT's blocks plus a WATERMARK of free headroom
    (``num_slots`` blocks by default, waived when no slot is running) so
    running decoders keep growing; ``grant`` maps decode blocks on demand,
    capped at each request's ``prompt + max_new_tokens`` budget and
    WIDENING the tables when a grant outruns them; a grant the pool
    cannot cover even after LRU-evicting unreferenced cached blocks returns
    None and the engine ``preempt``s the slot.

    With a ``prefix_cache`` (``launch.prefix_cache.RadixPrefixCache``)
    admission first walks the radix tree: the matched prefix's blocks are
    mapped into the slot's table shared (incref, read-only), only the
    uncached span reserves fresh blocks, a token-granular partial match
    allocates one extra block for the copy-on-write of the shared tail,
    and eviction INSERTS the request's prompt blocks into the tree before
    the slot's decref.
    """

    def __init__(self, num_slots: int,
                 allocator: Optional[BlockAllocator] = None,
                 table_width: int = 0, prefix_cache=None,
                 watermark: Optional[int] = None,
                 policy: Optional[SchedPolicy] = None):
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.queue: collections.deque[Request] = collections.deque()
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        self.policy = policy if policy is not None else FifoPolicy()
        self.preemptions = 0
        self._admit_preempted: list[tuple[int, Request]] = []
        self._seq = 0
        self.watermark = num_slots if watermark is None else watermark
        self.table_growths = 0
        if prefix_cache is not None and allocator is None:
            raise ValueError("prefix cache requires a BlockAllocator")
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
            self._slot_prefix: list[Optional[PrefixAdmit]] = \
                [None] * num_slots
            self._slot_cow_src: list[Optional[int]] = [None] * num_slots
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

    def _try_reserve(self, need: int, protect: frozenset) -> bool:
        """Reserve ``need`` blocks for an admission, keeping ``watermark``
        blocks free for running slots' grants (waived when none runs),
        LRU-evicting cached-but-unreferenced blocks first when the pool is
        short (``protect`` pins the hit being admitted)."""
        alloc = self.allocator
        wm = self.watermark if any(r is not None for r in self.slots) \
            else 0
        short = need + wm - alloc.available()
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict_lru(short, protect=protect)
        if alloc.available() < need + wm:
            return False
        return alloc.reserve(need)

    def _admit_paged(self, slot: int, qi: int) -> Optional[Request]:
        alloc = self.allocator
        req = self.queue[qi]
        P = len(req.prompt)
        nprompt = alloc.blocks_for(P)
        hit = self.prefix_cache.match(req.prompt) \
            if self.prefix_cache is not None else None
        if hit is not None and hit.tokens:
            # the uncached span, plus one block for the copy-on-write of a
            # partially matched shared tail
            need = nprompt - len(hit.blocks) + (1 if hit.partial else 0)
            if not self._try_reserve(need, frozenset(hit.blocks)):
                # liveness: when no live slot will ever free a block
                # (everything left is cache-held, pinned by this very
                # hit), admit cold rather than deadlock on the hit's own
                # protection
                if alloc.in_use > self.prefix_cache.cached_blocks():
                    return None           # a running slot will free some
                hit = None
        if hit is None or not hit.tokens:
            if not self._try_reserve(nprompt, frozenset()):
                return None               # pool exhausted: defer
            del self.queue[qi]
            ids = alloc.alloc(nprompt)
            if self.prefix_cache is not None:
                self._slot_prefix[slot] = PrefixAdmit(tokens=0)
        else:
            del self.queue[qi]
            self.prefix_cache.lock(hit)   # the slot's refs on shared blocks
            ids = list(hit.blocks)
            cow = None
            if hit.partial:
                [dst] = alloc.alloc(1)
                cow = (ids[-1], dst)      # src stays referenced: finish_cow
                self._slot_cow_src[slot] = ids[-1]
                ids[-1] = dst
            ids += alloc.alloc(nprompt - len(hit.blocks))
            self._slot_prefix[slot] = PrefixAdmit(tokens=hit.tokens, cow=cow)
        # grant cap, NOT a reservation: decode blocks come on demand
        self._slot_budget[slot] = alloc.blocks_for(P + req.max_new_tokens) \
            - nprompt
        self._slot_blocks[slot] = ids
        self._ensure_width(len(ids))
        self.block_tables[slot, :] = -1
        self.block_tables[slot, :len(ids)] = ids
        self.table_version += 1
        return req

    def prefix_admit(self, slot: int) -> Optional[PrefixAdmit]:
        """The slot's prefix-cache admission record (None when the cache
        is off)."""
        return self._slot_prefix[slot] if self.prefix_cache is not None \
            else None

    def finish_cow(self, slot: int) -> None:
        """The engine copied the shared tail block on the device; release
        this slot's reference on the source (the tree keeps its own)."""
        src = self._slot_cow_src[slot]
        if src is None:
            raise ValueError(f"no pending CoW on slot {slot}")
        self._slot_cow_src[slot] = None
        self.allocator.free([src])

    def _preempt_for(self, candidate: Request) -> bool:
        """Ask the policy for a decoding slot to preempt so ``candidate``
        can admit; False defers the candidate.  Only DECODING occupants
        are offered, and every preemption shrinks that set, so the admit
        loop ends."""
        running = [(i, r) for i, r in enumerate(self.slots)
                   if r is not None and r.state == "decoding"]
        victim = self.policy.victim(candidate, running)
        if victim is None:
            return False
        self._admit_preempted.append((victim, self.preempt(victim)))
        return True

    def take_preempted(self) -> list[tuple[int, Request]]:
        """The (slot, request) pairs the policy preempted inside the last
        ``admit``; the engine deactivates those slots before it acts on
        the new placements."""
        out = self._admit_preempted
        self._admit_preempted = []
        return out

    def admit(self) -> list[tuple[int, Request]]:
        placed = []
        self._admit_preempted = []
        while self.queue:
            qi = self.policy.select(self.queue)
            if qi is None:
                break
            candidate = self.queue[qi]
            slot = next((i for i, r in enumerate(self.slots) if r is None),
                        None)
            if slot is None:
                # every slot busy: preempt a worse decoding slot or stop
                if not self._preempt_for(candidate):
                    break
                continue
            if self.allocator is not None:
                req = self._admit_paged(slot, qi)
                if req is None:
                    # pool short: preempt for the candidate (the freed
                    # blocks retry the admission) or defer
                    if not self._preempt_for(candidate):
                        break
                    continue
            else:
                req = candidate
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
        if alloc.available() < n and self.prefix_cache is not None:
            # a cached-but-unreferenced prefix must never starve a running
            # decoder: reclaim before giving up
            self.prefix_cache.evict_lru(n - alloc.available(),
                                        protect=frozenset())
        if not alloc.reserve(n):
            return None
        ids = alloc.alloc(n)
        self._slot_budget[slot] -= n
        self._ensure_width(want)
        self.block_tables[slot, have:want] = ids
        self._slot_blocks[slot].extend(ids)
        self.table_version += 1
        return ids

    def rollback(self, slot: int, target_len: int) -> int:
        """Shrink a slot back to ``target_len`` tokens after a partially
        rejected speculative round: decode-granted blocks beyond
        ``blocks_for(target_len)`` return to the pool and re-credit the
        slot's grant budget.  ``target_len`` is at least the prompt length
        + 1, so every freed block was drawn by ``grant`` and is this slot's
        alone (never a shared prefix block).  Junk KV the draft wrote into
        the kept tail block lies above the depth: decode attention masks
        it and later steps overwrite it.  Returns the blocks released."""
        alloc = self.allocator
        if alloc is None:
            return 0
        keep = alloc.blocks_for(target_len)
        blocks = self._slot_blocks[slot]
        if keep >= len(blocks):
            return 0
        drop = blocks[keep:]
        del blocks[keep:]
        alloc.free(drop)
        self._slot_budget[slot] += len(drop)
        self.block_tables[slot, keep:] = -1
        self.table_version += 1
        return len(drop)

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
            if self.prefix_cache is not None:
                # adopt the prompt's blocks into the radix tree BEFORE the
                # slot lets go: chunks already cached share the existing
                # nodes, fresh ones pass to the cache
                nprompt = self.allocator.blocks_for(len(req.prompt))
                self.prefix_cache.insert(req.prompt,
                                         self._slot_blocks[slot][:nprompt])
                if self._slot_cow_src[slot] is not None:
                    self.allocator.free([self._slot_cow_src[slot]])
                    self._slot_cow_src[slot] = None
                self._slot_prefix[slot] = None
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
                blocks_utilization=a.utilization(),
                blocks_cached=(self.prefix_cache.cached_blocks()
                               if self.prefix_cache is not None else 0))
        return out

    def mapped_blocks(self, slot: int) -> int:
        """Physical blocks mapped into the slot's table (what the decode
        kernel can read)."""
        return len(self._slot_blocks[slot])

    def active(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
