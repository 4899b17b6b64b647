"""Real threaded XiTAO runtime.

The same scheduler/policy objects as the reference's simulator, driving
Python threads that execute real kernels.  On the card those are the
port's CUDA kernels, launched by the bodies of
:class:`repro_torch.core.real_kernels.KernelPool`; the runtime itself needs
no torch.  The device work and its synchronisation belong to the bodies:
a body returns once its chunk's writes have landed, so the leader's
elapsed time is the chunk's real execution time and a child is woken only
after its parents' outputs exist.

Mechanics mirror paper §3.1: per-worker WSQ (LIFO own end / FIFO steal end)
and FIFO AQ; a placed TAO is inserted into every member worker's AQ and each
member executes its chunk asynchronously; the leader measures elapsed time
around its own participation and updates the PTT.

This is the PyTorch port's copy of ``repro.core.runtime``.  One addition:
an exception raised by a body ends the run and is raised again from
:meth:`ThreadedRuntime.run`, where the reference's worker would die and
leave the run to its timeout.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Callable

from .dag import TaskDAG, TaskNode, is_critical_child
from .places import Place
from .scheduler import SchedulingPolicy

# A TAO body: callable(chunk_index, width) -> None, executing 1/width of the
# task's parallel work.
TAOBody = Callable[[int, int], None]


@dataclasses.dataclass
class _LiveTAO:
    node: TaskNode
    place: Place
    body: TAOBody
    remaining: int
    lock: threading.Lock
    t_dispatch: float
    leader_elapsed: float = 0.0


class ThreadedRuntime:
    def __init__(self, policy: SchedulingPolicy, num_workers: int,
                 seed: int = 0):
        self.policy = policy
        self.n = num_workers
        self._wsq: list[deque[TaskNode]] = [deque() for _ in range(num_workers)]
        self._wsq_locks = [threading.Lock() for _ in range(num_workers)]
        self._aq: list[deque[_LiveTAO]] = [deque() for _ in range(num_workers)]
        self._aq_locks = [threading.Lock() for _ in range(num_workers)]
        self._rngs = [random.Random(seed * 1000 + i) for i in range(num_workers)]
        self._done = threading.Event()
        self._n_left = 0
        self._count_lock = threading.Lock()
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def run(self, dag: TaskDAG, bodies: dict[int, TAOBody],
            timeout: float = 120.0) -> dict[int, tuple[int, int]]:
        """Execute the DAG; bodies maps node id -> TAO body.
        Returns {nid: (leader, width)} placements."""
        dag.reset_runtime_state()
        self._dag = dag
        self._bodies = bodies
        self._crit = [False] * len(dag.nodes)
        self._placements: dict[int, tuple[int, int]] = {}
        self._n_left = len(dag.nodes)
        self._error = None
        self._done.clear()
        if self._n_left == 0:
            return {}
        roots = dag.roots()
        chain_head = max(roots, key=lambda r: dag.nodes[r].criticality)
        self._chain_head = chain_head
        for i, rid in enumerate(roots):
            self._wsq[i % self.n].append(dag.nodes[rid])
        threads = [threading.Thread(target=self._worker, args=(w,), daemon=True)
                   for w in range(self.n)]
        for t in threads:
            t.start()
        finished = self._done.wait(timeout)
        if not finished:
            self._done.set()              # stop the workers
        for t in threads:
            t.join(timeout=5.0)
        if self._error is not None:
            raise RuntimeError("a TAO body failed") from self._error
        if not finished:
            raise TimeoutError(f"{self._n_left} tasks never completed")
        return self._placements

    # ------------------------------------------------------------------
    def _dispatch(self, node: TaskNode, worker: int) -> None:
        critical = self._crit[node.nid]
        place = self.policy.place(node, worker, critical)
        live = _LiveTAO(node=node, place=place, body=self._bodies[node.nid],
                        remaining=place.width, lock=threading.Lock(),
                        t_dispatch=time.perf_counter())
        self._placements[node.nid] = (place.leader, place.width)
        for m in place.cores:
            with self._aq_locks[m]:
                self._aq[m].append(live)

    def _execute_chunk(self, live: _LiveTAO, worker: int) -> None:
        i = worker - live.place.leader
        t0 = time.perf_counter()
        try:
            live.body(i, live.place.width)
        except Exception as e:            # end the run; run() raises it
            self._error = e
            self._done.set()
            return
        el = time.perf_counter() - t0
        with live.lock:
            if i == 0:
                live.leader_elapsed = el
            live.remaining -= 1
            last = live.remaining == 0
        if last:
            self._complete(live)

    def _complete(self, live: _LiveTAO) -> None:
        node = live.node
        self.policy.record(node, live.place, live.leader_elapsed)
        parent_on_chain = (self._crit[node.nid]
                          or node.nid == self._chain_head)
        marked = False
        for cid in node.children:
            child = self._dag.nodes[cid]
            if parent_on_chain and not marked and is_critical_child(node, child):
                self._crit[cid] = True
                marked = True
            with self._count_lock:
                child.n_pending_parents -= 1
                ready = child.n_pending_parents == 0
            if ready:
                w = live.place.leader
                with self._wsq_locks[w]:
                    self._wsq[w].append(child)
        with self._count_lock:
            self._n_left -= 1
            if self._n_left == 0:
                self._done.set()

    def _worker(self, w: int) -> None:
        rng = self._rngs[w]
        while not self._done.is_set():
            # 1) assembly queue has priority
            live = None
            with self._aq_locks[w]:
                if self._aq[w]:
                    live = self._aq[w].popleft()
            if live is not None:
                self._execute_chunk(live, w)
                continue
            # 2) own WSQ (LIFO)
            node = None
            with self._wsq_locks[w]:
                if self._wsq[w]:
                    node = self._wsq[w].pop()
            if node is not None:
                self._dispatch(node, w)
                continue
            # 3) random steal (FIFO end)
            v = rng.randrange(self.n)
            if v != w:
                with self._wsq_locks[v]:
                    node = self._wsq[v].popleft() if self._wsq[v] else None
                if node is not None:
                    self._dispatch(node, w)
                    continue
            time.sleep(0.0002)
