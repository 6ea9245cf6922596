"""Scheduling policies (the admission / eviction decision layer).

Counterpart of ``repro.launch.engine.policy``.  ``SchedPolicy`` is the
interface ``scheduler.SlotScheduler`` consults at every admission: WHICH
queued request to try next (``select``) and, when no slot or not enough
pool is free for it, WHICH running slot to preempt on its behalf
(``victim``).  The scheduler keeps the mechanism (reservations, tables,
requeueing), so a policy is a pure ranking function over host-side
request state and never touches the allocator.

``FifoPolicy`` is the reference: always the queue head, no skip-ahead,
never a preemption at admission.  ``PriorityPolicy`` ranks by (priority
class, SLO deadline, submission order) and, under pressure, preempts the
worst *decoding* slot of a strictly worse class.  Only decoding slots are
preemptible: a decode replays from the prompt (bit for bit in operand
entropy when the request lands back in the same slot), whereas aborting
a prefill walk would waste the chunks already paid for.
"""

from __future__ import annotations

from typing import Optional


class SchedPolicy:
    """Admission-ranking interface the scheduler consults.

    ``select`` returns the queue INDEX of the request to try admitting
    next (None defers admission); ``victim`` returns the slot to preempt
    so ``candidate`` can admit (None defers the candidate).  ``running``
    holds decoding slots only: the scheduler filters the states."""

    name = "base"

    def select(self, queue) -> Optional[int]:
        raise NotImplementedError

    def victim(self, candidate, running) -> Optional[int]:
        raise NotImplementedError


class FifoPolicy(SchedPolicy):
    """Queue head only, defer on failure, never preempt for an admission
    (a grant failure still preempts: that is the engine's last resort,
    not an admission decision)."""

    name = "fifo"

    def select(self, queue) -> Optional[int]:
        return 0 if queue else None

    def victim(self, candidate, running) -> Optional[int]:
        return None


class PriorityPolicy(SchedPolicy):
    """Priority classes, SLO deadlines and preemption under pressure.

    Rank key ``(priority, deadline, seq)``: a lower priority value is the
    better class, ``deadline = t_submit + slo_s`` (inf without an SLO)
    serves earliest-deadline-first inside a class, and the submission
    sequence breaks the remaining ties, so one-class traffic is served in
    FIFO order.  ``victim`` takes the decoding slot of the numerically
    LARGEST priority, strictly worse than the candidate's (never a peer),
    with the fewest emitted tokens (the cheapest replay), then the
    youngest submission.  Under a tensor-parallel mesh ``t_submit`` is
    rank 0's stamp on every rank (``ServeEngine._run`` broadcasts it), so
    the ranks rank the queue alike."""

    name = "priority"

    @staticmethod
    def _deadline(req) -> float:
        return req.t_submit + req.slo_s if req.slo_s is not None \
            else float("inf")

    def select(self, queue) -> Optional[int]:
        if not queue:
            return None
        keys = [(r.priority, self._deadline(r), r.seq) for r in queue]
        return min(range(len(queue)), key=keys.__getitem__)

    def victim(self, candidate, running) -> Optional[int]:
        worse = [(slot, r) for slot, r in running
                 if r.priority > candidate.priority]
        if not worse:
            return None
        slot, _ = max(worse, key=lambda sr: (sr[1].priority,
                                             -len(sr[1].tokens), sr[1].seq))
        return slot


_POLICIES = {"fifo": FifoPolicy, "priority": PriorityPolicy}


def get_policy(name: str) -> SchedPolicy:
    """A fresh policy instance for a ``--policy`` name."""
    if name not in _POLICIES:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"choose from {sorted(_POLICIES)}")
    return _POLICIES[name]()
