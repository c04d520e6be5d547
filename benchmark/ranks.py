"""The processes of a run on more than one device: rank 0 is the harness's
own process, ranks 1 .. n-1 are started here, one a device.

Rank 0 makes a ``Group``: it serves a TCP store on a free port of
localhost, starts the other ranks with the ``spawn`` start method, and
joins them in one ``torch.distributed`` process group over that store
(NCCL on the cards, gloo on the CPU).  Each rank (``worker``) takes its
device (``cuda:<rank>``), joins, rebuilds the cell from its files, and runs
its traffic loop's ``rank_main``: its side of the units.  Rank 0 sends the
units through the store, each a JSON object under a key of its own
(``Group.send``, ``Rank.receive``), so that the loop's own collectives are
the only ones on the devices.  A rank ends by writing ``rank<r>.json``
(the summary its loop returns, and what it held of ``core.FORBIDDEN``)
into the run's directory; ``Group.close`` reads them.

No rank outlives a failure.  A rank that raises prints its traceback and
exits non-zero.  Rank 0 watches the others' exit codes while they run:
when one ends before it was told to stop, rank 0 stops the rest and its
process exits with ``FAILED_EXIT`` and no result, whatever it was waiting
on.  A rank started here is killed by the kernel when rank 0's process
ends (``PR_SET_PDEATHSIG``).
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import signal
import sys
import threading
import traceback
from datetime import timedelta
from typing import List, Optional

import torch

from benchmark import core

FAILED_EXIT = 4
# How long a rank waits for the group, a unit or a collective; failures are
# caught by the exit codes long before.  A checkout's first run builds the
# kernels inside its warm-up.
TIMEOUT = timedelta(seconds=600)
# Seconds a rank has to end after the stop, or after it is told to.
END_S = 30.0
POLL_S = 0.1
HOST = "127.0.0.1"


def device_of(device_type: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank>``, or the CPU."""
    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")


def _join(store, rank: int, world: int, dev) -> None:
    from torch import distributed as dist

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world, timeout=TIMEOUT)


def _leave() -> None:
    from torch import distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _leave_within(seconds: float) -> None:
    """``_leave``, or when it has not returned within ``seconds`` (a peer
    gone from under a collective teardown), the process ends with
    ``FAILED_EXIT``."""
    done = threading.Event()

    def leave():
        _leave()
        done.set()

    threading.Thread(target=leave, name="ranks-leave", daemon=True).start()
    if not done.wait(seconds):
        print("benchmark: the process group did not close", file=sys.stderr, flush=True)
        os._exit(FAILED_EXIT)


def _call_hook(name: Optional[str], rank: int) -> None:
    """``core.Run.rank_hook``: "module:function", called with the rank."""
    if name:
        module, fn = name.split(":")
        getattr(importlib.import_module(module), fn)(rank)


class _Barriers:
    """Host barriers of all the ranks over the store, each under a key of
    its own (no collective on the devices)."""

    def __init__(self, store, world: int):
        self.store, self.world, self.n = store, world, 0

    def __call__(self) -> None:
        key = f"barrier/{self.n}"
        self.n += 1
        if self.store.add(key, 1) == self.world:
            self.store.set(key + "/all", "1")
        self.store.wait([key + "/all"])


def _summary_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"rank{rank}.json")


class Group:
    """Rank 0's handle on the run's ranks: ``start`` them, ``join`` the
    group, ``send`` units (and meet them at a ``barrier``), then ``close``
    (or ``abort`` on a failure)."""

    def __init__(self, run: core.Run, world: int):
        self.run, self.world = run, int(world)
        self.dev = device_of(torch.device(run.device).type, 0)
        self.procs: List = []
        self.store = None
        self.sent = 0
        self._ending = threading.Event()

    def start(self) -> None:
        """Serve the store and start ranks 1 .. world - 1, which import and
        load the scene the run wrote while rank 0 loads its own."""
        import multiprocessing

        from torch import distributed as dist

        self.store = dist.TCPStore(HOST, 0, self.world, is_master=True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        self.barrier = _Barriers(self.store, self.world)
        spawn = multiprocessing.get_context("spawn")
        for r in range(1, self.world):
            p = spawn.Process(
                target=worker, name=f"rank{r}", daemon=True,
                args=(r, self.world, self.store.port, self.run.cell.files,
                      self.run.workdir, self.dev.type, self.run.rank_hook,
                      os.getpid()))
            p.start()
            self.procs.append(p)
        threading.Thread(target=self._watch, name="ranks-watch", daemon=True).start()

    def join(self) -> None:
        """Join the process group (it forms once every rank has) and call
        the run's hook."""
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        _join(self.store, 0, self.world, self.dev)
        _call_hook(self.run.rank_hook, 0)

    def send(self, unit: dict) -> None:
        self.store.set(f"unit/{self.sent}", json.dumps(unit))
        self.sent += 1

    def _watch(self) -> None:
        while not self._ending.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode is not None and not self._ending.is_set():
                    print(f"benchmark: rank {r} ended with exit code {p.exitcode} "
                          "while the run needed it; the run stops without a result",
                          file=sys.stderr, flush=True)
                    self._end_procs(0.0)
                    self.run.cleanup()
                    sys.stdout.flush()
                    os._exit(FAILED_EXIT)

    def _end_procs(self, grace: float) -> None:
        """Wait ``grace`` seconds for the ranks to end, then terminate and
        at last kill what is left, and reap every one."""
        for p in self.procs:
            p.join(grace)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)

    def close(self) -> List[dict]:
        """Tell the ranks to stop, leave the group with them (NCCL's
        teardown waits for every rank), wait until each has ended: [each
        rank's summary], ranks 1 .. world - 1 in order.  Raises if a rank
        failed."""
        self._ending.set()
        try:
            self.send({"stop": True})
            _leave_within(END_S)
        finally:
            self._end_procs(END_S)
        failed = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks failed at the end of the run: {failed}")
        out = []
        for r in range(1, self.world):
            with open(_summary_path(self.run.workdir, r)) as fh:
                out.append(json.load(fh))
        return out

    def abort(self) -> None:
        """After a failure on rank 0: end the other ranks and leave the group
        (a rank waiting in a collective is terminated)."""
        self._ending.set()
        self._end_procs(0.0)
        _leave_within(END_S)


class Rank:
    """A started rank's side: its place, device and cell, the run's
    directory, the units rank 0 sends (``receive``) and the ``barrier``."""

    def __init__(self, rank: int, world: int, store, dev, workdir: str, cell):
        self.rank, self.world, self.store = rank, world, store
        self.dev, self.workdir, self.cell = dev, workdir, cell
        self.received = 0
        self.barrier = _Barriers(store, world)

    def receive(self) -> dict:
        unit = json.loads(self.store.get(f"unit/{self.received}"))
        self.received += 1
        return unit


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when its parent's ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(FAILED_EXIT)


def worker(rank: int, world: int, port: int, files: tuple, workdir: str,
           device_type: str, hook: Optional[str], parent: int) -> None:
    """Rank ``rank`` of a run: join, run the cell's loop's ``rank_main``,
    write its summary; exits 0 only if all of that succeeded."""
    _die_with(parent)
    code = FAILED_EXIT
    try:
        from torch import distributed as dist

        dev = device_of(device_type, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        store = dist.TCPStore(HOST, port, world, is_master=False, timeout=TIMEOUT)
        _join(store, rank, world, dev)
        cell = core.Cell(files[0]["name"], files)
        _call_hook(hook, rank)
        summary = cell.loop.rank_main(Rank(rank, world, store, dev, workdir, cell))
        summary.update(rank=rank, loaded=core.forbidden_modules())
        path = _summary_path(workdir, rank)
        with open(path + ".tmp", "w") as fh:
            json.dump(summary, fh)
        os.replace(path + ".tmp", path)
        _leave()
        code = 0
    except Exception:  # the rank's boundary: reported by its exit code
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
