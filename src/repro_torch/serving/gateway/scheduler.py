"""SLO-aware request scheduler (a copy of
``repro/serving/gateway/scheduler.py``): priority classes, EDF within a
class, admission control through the engine's predicate and preemption
victims. The reference's cancel (``remove``), deadline expiry
(``drop_expired``), prefetch peek (``upcoming``) and chunked-prefill budget
(``plan_prefill``) wait for the slices that use them.

``Request`` is imported for type checking only, so the engine, which builds
its default ``Scheduler``, and this module import without a cycle.
"""
from __future__ import annotations

import bisect
import itertools
import math
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from repro_torch.serving.engine import Request


class Scheduler:
    def __init__(self, max_queue: int = 4096):
        self.max_queue = max_queue
        # kept sorted by _key (keys are immutable per request), so pop/peek
        # are in-order scans rather than per-call sorts
        self._entries: List["Request"] = []
        self._seq = itertools.count()
        # admissions that bypassed a pool-blocked head
        self.hol_bypasses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _key(self, req: "Request") -> Tuple:
        deadline = req.deadline_s if req.deadline_s is not None else math.inf
        return (req.priority, deadline, req._seq)

    def push(self, req: "Request") -> bool:
        """Enqueue; False (rejected) when the queue is at capacity."""
        if len(self._entries) >= self.max_queue:
            return False
        req._seq = next(self._seq)
        bisect.insort(self._entries, req, key=self._key)
        return True

    def requeue(self, req: "Request") -> None:
        """Re-admit a preempted request (keeps its original arrival order
        via the old _seq)."""
        bisect.insort(self._entries, req, key=self._key)

    def peek(self, pred: Optional[Callable[["Request"], bool]] = None
             ) -> Optional["Request"]:
        """Best entry (optionally the best one satisfying ``pred``)."""
        for req in self._entries:
            if pred is None or pred(req):
                return req
        return None

    def pop_next(self, can_admit: Callable[["Request"], bool] = lambda r: True,
                 prefer: Optional[Callable[["Request"], bool]] = None
                 ) -> Optional["Request"]:
        """Best admissible entry in (priority, deadline, arrival) order.
        ``prefer`` breaks arrival ties only: among admissible entries with
        the same (priority, deadline) key, one satisfying it goes first."""
        best_i: Optional[int] = None
        blocked_ahead = 0
        for i, req in enumerate(self._entries):
            if best_i is None:
                if can_admit(req):
                    best_i = i
                    if prefer is None or prefer(req):
                        break
                else:
                    blocked_ahead += 1
                continue
            head = self._entries[best_i]
            head_dl = head.deadline_s if head.deadline_s is not None else math.inf
            req_dl = req.deadline_s if req.deadline_s is not None else math.inf
            if req.priority != head.priority or req_dl != head_dl:
                break            # a different key can never be preferred
            if can_admit(req) and prefer(req):
                best_i = i
                break
        if best_i is None:
            return None
        if blocked_ahead:
            self.hol_bypasses += 1
        return self._entries.pop(best_i)

    def pick_victim(self, active: Sequence[Tuple[int, "Request"]],
                    below_priority: Optional[int] = None) -> Optional[int]:
        """Slot to preempt: youngest request of the lowest-priority class.
        ``below_priority`` restricts victims to classes strictly less urgent
        than the given one."""
        candidates = [(slot, r) for slot, r in active
                      if below_priority is None or r.priority > below_priority]
        if not candidates:
            return None
        slot, _ = max(candidates, key=lambda sr: (sr[1].priority, sr[1].t_admit))
        return slot
