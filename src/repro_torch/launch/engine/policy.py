"""Scheduling policies (the admission decision layer).

``SchedPolicy`` is the interface ``scheduler.SlotScheduler`` consults at
every admission: WHICH queued request to try next (``select``).  The
scheduler keeps the mechanism (reservations, tables, requeueing), so a
policy is a pure ranking function over host-side request state.

``FifoPolicy`` is the reference: always the queue head, no skip-ahead,
and a request that cannot admit defers the rest of the queue.  The JAX
package's priority policy (class ranking plus admission-time preemption)
is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional


class SchedPolicy:
    """Admission-ranking interface the scheduler consults: the queue
    INDEX of the request to try next, or None to defer admission."""

    name = "base"

    def select(self, queue) -> Optional[int]:
        raise NotImplementedError


class FifoPolicy(SchedPolicy):
    name = "fifo"

    def select(self, queue) -> Optional[int]:
        return 0 if queue else None

