"""A world of rank processes on one host, kept alive across tasks.

``World(n, backend, device)`` starts n spawned processes that join one
process group (``initialize_multihost`` at ``127.0.0.1``) and then run
tasks: ``world.run(fn, *args)`` calls the module-level function ``fn`` on
every rank at once and returns the ranks' results in rank order.  It is
how ``graft_entry.dryrun_multichip``, the tests and ``chip_smoke.py``
drive the multi-device path without a launcher.

Nothing waits forever: every collective of the group times out after
``timeout_s``, a task's results are awaited at most ``timeout_s``, and a
task that fails or times out on any rank kills the whole world (the next
``run`` starts a new one), so no rank is left waiting in a collective.
Results travel by pickle: return numpy arrays or plain values, not
tensors.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback

import torch


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, device, timeout_s, threads, tasks,
               results):
    if threads:
        torch.set_num_threads(threads)
    try:
        from .multihost import initialize_multihost

        initialize_multihost(f"127.0.0.1:{port}", n, rank,
                             timeout_s=timeout_s, backend=backend,
                             device=device)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class WorldError(RuntimeError):
    """A rank failed or did not answer in time; the world was killed."""


class World:
    """n rank processes over one process group (see the module)."""

    def __init__(self, n: int, backend: str = "gloo",
                 device: str = "cpu", timeout_s: float = 120.0,
                 threads: int | None = None):
        self.n = n
        self.backend = backend
        self.device = device
        self.timeout_s = timeout_s
        self.threads = threads
        self._procs: list = []

    def _start(self) -> None:
        from .multihost import check_backend

        check_backend(self.backend, self.device, self.n)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        port = free_port()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.n, port, self.backend, self.device,
                int(self.timeout_s), self.threads, self._tasks[r],
                self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        out: list = [None] * self.n
        errors = []
        try:
            for _ in range(self.n):
                rank, ok, value = self._results.get(timeout=self.timeout_s)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break  # the others may wait in a collective: stop
        except queue.Empty:
            errors.append(f"no answer within {self.timeout_s} s")
        if errors:
            self.close(kill=True)
            raise WorldError(f"{what} failed on a world of {self.n} ranks: "
                             + "\n".join(errors))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the results by rank."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", "task"))

    def close(self, kill: bool = False) -> None:
        """Stop every rank process (at once with ``kill``)."""
        procs, self._procs = self._procs, []
        if procs and not kill:
            for q in self._tasks:
                q.put(None)
            for p in procs:
                p.join(10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)

