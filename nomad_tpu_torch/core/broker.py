"""Evaluation broker (reference ``nomad_tpu/core/broker.py``).

In-memory dispatch queue for evaluations:

- one ready queue per scheduler type, priority-ordered FIFO;
- per-job serialization: at most one eval of a job is ready or unacked
  at a time, the rest wait in a per-job pending heap and the latest is
  promoted on ack (the older ones are cancelled);
- ``dequeue`` / ``dequeue_batch`` hand out a delivery token that ack and
  nack must present;
- an unacked eval is redelivered after ``nack_timeout``; past
  ``delivery_limit`` deliveries it lands in the ``_failed`` queue, which
  the Server's reaper drains;
- an eval with ``wait_until`` in the future sits in a delay heap until
  it is due.

Not ported: the ``loadctl`` admission hook (its watermarks, 8,192 and
32,768 pending evals in the reference's defaults, never shed at this
path's sizes: the C2M rung queues at most a few hundred evals) and the
poison-eval quarantine that rides on it (a job whose evals keep hitting
the delivery limit keeps re-entering the failed queue instead).
"""

from __future__ import annotations

import copy as _copy
import heapq
import itertools
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ..obs import RECORDER, REGISTRY, TRACER
from ..structs import enums
from ..structs.evaluation import Evaluation

FAILED_QUEUE = "_failed"
# long enough that a slow eval is never redelivered mid-flight
DEFAULT_NACK_TIMEOUT = 60.0
DEFAULT_DELIVERY_LIMIT = 3


class EvalBroker:
    def __init__(self, nack_timeout: float = DEFAULT_NACK_TIMEOUT,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT):
        self.nack_timeout = nack_timeout
        self.delivery_limit = delivery_limit

        self._lock = threading.Condition()
        self._enabled = False
        self._seq = itertools.count()

        # sched type -> heap of (-priority, seq, eval_id)
        self._ready: Dict[str, List[Tuple[int, int, str]]] = {}
        self._evals: Dict[str, Evaluation] = {}  # ready evals by id
        # (ns, job) -> its ready or unacked eval id
        self._job_tracked: Dict[Tuple[str, str], str] = {}
        # (ns, job) -> heap of (-modify_index, seq, eval) waiting a turn
        self._pending: Dict[Tuple[str, str],
                            List[Tuple[int, int, Evaluation]]] = {}
        self._unacked: Dict[str, dict] = {}  # id -> token, timer, ...
        self._delay: List[Tuple[float, int, Evaluation]] = []
        self._delivery_counts: Dict[str, int] = {}
        # first-enqueue time: ack observes nomad.eval.enqueue_to_commit
        self._enqueue_times: Dict[str, float] = {}
        self._cancelled: List[Evaluation] = []  # superseded pending evals
        self._delay_thread: Optional[threading.Thread] = None
        # a delay thread of an older enable exits on its next wakeup
        self._delay_gen = 0
        self.stats = {"enqueued": 0, "dequeued": 0, "acked": 0, "nacked": 0}

    # -- lifecycle --

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            if enabled and not self._enabled:
                self._enabled = True
                self._delay_gen += 1
                self._delay_thread = threading.Thread(
                    target=self._run_delay, args=(self._delay_gen,),
                    daemon=True, name="broker-delay")
                self._delay_thread.start()
            elif not enabled and self._enabled:
                self._enabled = False
                self._flush_locked()
                self._lock.notify_all()
        if not enabled and self._delay_thread is not None:
            self._delay_thread.join(timeout=2.0)

    def _flush_locked(self) -> None:
        for info in self._unacked.values():
            info["timer"].cancel()
        self._ready.clear()
        self._evals.clear()
        self._job_tracked.clear()
        self._pending.clear()
        self._unacked.clear()
        self._delay.clear()
        self._cancelled.clear()
        self._enqueue_times.clear()

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- enqueue --

    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            if not self._enabled:
                return
            self._enqueue_locked(ev)
            self._lock.notify_all()

    def enqueue_all(self, evals: List[Evaluation]) -> None:
        with self._lock:
            if not self._enabled:
                return
            for ev in evals:
                self._enqueue_locked(ev)
            self._lock.notify_all()

    def _enqueue_locked(self, ev: Evaluation) -> None:
        if ev.id in self._evals or ev.id in self._unacked:
            return
        self.stats["enqueued"] += 1
        now = time.time()
        self._enqueue_times.setdefault(ev.id, now)
        TRACER.event("eval.enqueued", trace=ev.trace(), job=ev.job_id)
        RECORDER.record("broker", "enqueue", eval=ev.id[:8],
                        job=ev.job_id, type=ev.type)
        if ev.wait_until and ev.wait_until > now:
            heapq.heappush(self._delay, (ev.wait_until, next(self._seq), ev))
            self._lock.notify_all()  # the delay loop re-sleeps
            return
        key = (ev.namespace, ev.job_id)
        if ev.job_id and key in self._job_tracked:
            # a sibling of this job is in flight: wait in pending
            heapq.heappush(self._pending.setdefault(key, []),
                           (-ev.modify_index, next(self._seq), ev))
            return
        if ev.job_id:
            self._job_tracked[key] = ev.id
        self._evals[ev.id] = ev
        queue = (FAILED_QUEUE if ev.status == enums.EVAL_STATUS_FAILED
                 else ev.type)
        heapq.heappush(self._ready.setdefault(queue, []),
                       (-ev.priority, next(self._seq), ev.id))

    # -- dequeue --

    def dequeue(self, sched_types: List[str],
                timeout: Optional[float] = None
                ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue across the given queues -> (eval, token), or
        (None, "") on timeout or disable."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return None, ""
                best = self._best_ready_locked(sched_types)
                if best is not None:
                    return self._deliver_locked(*best)
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return None, ""
                self._lock.wait(remaining if remaining is not None else 1.0)

    def dequeue_batch(self, sched_types: List[str], max_batch: int = 8,
                      timeout: Optional[float] = None,
                      ) -> List[Tuple[Evaluation, str]]:
        """Wait as ``dequeue`` does for the first ready eval, then take
        up to ``max_batch - 1`` more that are ready now, never waiting
        for stragglers. Each member has its own token and nack timer;
        job siblings never share a batch. [] on timeout or disable."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return []
                out: List[Tuple[Evaluation, str]] = []
                while len(out) < max_batch:
                    best = self._best_ready_locked(sched_types)
                    if best is None:
                        break
                    out.append(self._deliver_locked(*best))
                if out:
                    return out
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return []
                self._lock.wait(remaining if remaining is not None else 1.0)

    def _best_ready_locked(self, sched_types: List[str]
                           ) -> Optional[Tuple[str, Tuple[int, int, str]]]:
        best = None
        for st in sched_types:
            heap = self._ready.get(st)
            while heap and heap[0][2] not in self._evals:
                heapq.heappop(heap)  # stale entry
            if heap and (best is None or heap[0] < best[1]):
                best = (st, heap[0])
        return best

    def _deliver_locked(self, st: str, entry: Tuple[int, int, str]
                        ) -> Tuple[Evaluation, str]:
        """Pop a ready entry, mint its token, arm its nack timer."""
        eval_id = entry[2]
        heapq.heappop(self._ready[st])
        ev = self._evals.pop(eval_id)
        token = str(uuid.uuid4())
        timer = threading.Timer(self.nack_timeout,
                                self._nack_timeout, (eval_id, token))
        timer.daemon = True
        info = {"token": token, "eval": ev, "timer": timer, "queue": st,
                "deliveries": self._delivery_counts.get(eval_id, 0) + 1}
        self._unacked[eval_id] = info
        timer.start()
        self.stats["dequeued"] += 1
        t0 = self._enqueue_times.get(eval_id)
        if t0 is not None:
            TRACER.add_span("eval.queued", t0, time.time(),
                            trace=ev.trace(),
                            deliveries=info["deliveries"])
        RECORDER.record("broker", "dequeue", eval=eval_id[:8],
                        deliveries=info["deliveries"])
        return ev, token

    # -- ack / nack --

    def ack(self, eval_id: str, token: str) -> None:
        with self._lock:
            info = self._unacked.get(eval_id)
            if info is None or info["token"] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            info["timer"].cancel()
            del self._unacked[eval_id]
            self._delivery_counts.pop(eval_id, None)
            self.stats["acked"] += 1
            t0 = self._enqueue_times.pop(eval_id, None)
            if t0 is not None:
                REGISTRY.observe("nomad.eval.enqueue_to_commit",
                                 time.time() - t0)
            ev = info["eval"]
            TRACER.event("eval.ack", trace=ev.trace())
            RECORDER.record("broker", "ack", eval=eval_id[:8])
            key = (ev.namespace, ev.job_id)
            if self._job_tracked.get(key) == eval_id:
                del self._job_tracked[key]
            self._promote_pending_locked(key)

    def _promote_pending_locked(self, key: Tuple[str, str]) -> None:
        """Promote the job's latest pending eval; older ones are
        cancelled (on copies: store snapshots share the objects)."""
        pending = self._pending.pop(key, None)
        if pending:
            _, _, nxt = heapq.heappop(pending)
            for _, _, stale in pending:
                upd = _copy.copy(stale)
                upd.status = enums.EVAL_STATUS_CANCELLED
                upd.status_description = (
                    "cancelled after more recent eval was processed")
                self._cancelled.append(upd)
                self._enqueue_times.pop(stale.id, None)
            self._enqueue_locked(nxt)
            self._lock.notify_all()

    def nack(self, eval_id: str, token: str) -> None:
        with self._lock:
            info = self._unacked.get(eval_id)
            if info is None or info["token"] != token:
                raise ValueError(f"token mismatch for eval {eval_id}")
            info["timer"].cancel()
            del self._unacked[eval_id]
            self.stats["nacked"] += 1
            RECORDER.record("broker", "nack", eval=eval_id[:8],
                            deliveries=info["deliveries"])
            self._redeliver_locked(info)

    def _nack_timeout(self, eval_id: str, token: str) -> None:
        with self._lock:
            info = self._unacked.get(eval_id)
            if info is None or info["token"] != token:
                return
            del self._unacked[eval_id]
            RECORDER.record("broker", "nack_timeout", eval=eval_id[:8],
                            deliveries=info["deliveries"])
            self._redeliver_locked(info)

    def _redeliver_locked(self, info: dict) -> None:
        ev = info["eval"]
        key = (ev.namespace, ev.job_id)
        if self._job_tracked.get(key) == ev.id:
            del self._job_tracked[key]
        self._delivery_counts[ev.id] = info["deliveries"]
        if info["deliveries"] >= self.delivery_limit:
            # too many failed deliveries: the failed queue
            RECORDER.record("broker", "failed_queue", eval=ev.id[:8],
                            deliveries=info["deliveries"])
            self._evals[ev.id] = ev
            if ev.job_id:
                self._job_tracked[key] = ev.id
            heapq.heappush(self._ready.setdefault(FAILED_QUEUE, []),
                           (-ev.priority, next(self._seq), ev.id))
        else:
            self._enqueue_locked(ev)
        self._lock.notify_all()

    # -- delayed evals --

    def _run_delay(self, gen: int) -> None:
        while True:
            with self._lock:
                if not self._enabled or gen != self._delay_gen:
                    return
                now = time.time()
                while self._delay and self._delay[0][0] <= now:
                    _, _, ev = heapq.heappop(self._delay)
                    ev = _copy.copy(ev)  # store snapshots share the original
                    ev.wait_until = 0.0
                    self._enqueue_locked(ev)
                    self._lock.notify_all()
                sleep_for = (self._delay[0][0] - now) if self._delay else 0.2
                self._lock.wait(min(max(sleep_for, 0.01), 0.2))

    # -- introspection --

    def inflight(self) -> int:
        with self._lock:
            return len(self._unacked)

    def ready_count(self) -> int:
        with self._lock:
            return len(self._evals)

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._pending.values())

    def delayed_count(self) -> int:
        with self._lock:
            return len(self._delay)

    def wait_for_reaper_work(self, timeout: Optional[float] = None) -> bool:
        """Block until a failed-queue eval is ready or cancelled evals
        await persisting. False on timeout or disable."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while True:
                if not self._enabled:
                    return False
                heap = self._ready.get(FAILED_QUEUE)
                while heap and heap[0][2] not in self._evals:
                    heapq.heappop(heap)
                if heap or self._cancelled:
                    return True
                remaining = (None if deadline is None
                             else deadline - time.time())
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(remaining if remaining is not None else 1.0)

    def failed_evals(self) -> List[Evaluation]:
        with self._lock:
            heap = self._ready.get(FAILED_QUEUE, [])
            return [self._evals[eid] for _, _, eid in heap
                    if eid in self._evals]

    def drain_cancelled(self) -> List[Evaluation]:
        with self._lock:
            out, self._cancelled = self._cancelled, []
            return out
