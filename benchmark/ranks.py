"""A cell over several cards: one process a card, joined by the port's own
``parallel/multihost.py::initialize_distributed`` (NCCL on the cards, gloo
on the CPU) at a free port on localhost, as ``fit`` runs under torchrun.
Rank 0 reports. The ranks are plain child processes (``subprocess``, not
``multiprocessing``, whose spawn start adds a resource-tracker process that
can outlive the launcher). The launcher waits for every rank, ends the
others when one fails or when it is itself ended, and exits with the first
failure's code. No process it started outlives it."""

import os
import pickle
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

COLLECTIVE_TIMEOUT_S = 300  # a rank that waits longer for the others fails
STOP_GRACE_S = 10  # after SIGTERM, before SIGKILL
ROOT = Path(__file__).resolve().parent.parent
CHILD = f"import sys; sys.path.insert(0, {str(ROOT)!r}); from benchmark.ranks import child; child()"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, cell, seed, seconds, trace_on, t_process, device, fault):
    from color_transfer_tpu_torch.parallel.multihost import initialize_distributed

    from benchmark.faults import plant
    from benchmark.run import execute, report

    device = f"cuda:{rank}" if device == "cuda" else device
    initialize_distributed(f"localhost:{port}", cell.chips, rank, device=device,
                           timeout=COLLECTIVE_TIMEOUT_S)
    with plant(fault, cell.config):
        result, notes = execute(cell, seed, seconds, trace_on, device, t_process)
    return report(result, notes) if rank == 0 else 0


def _die_with_parent():
    """Linux: this process gets SIGKILL when its launcher dies."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def child():
    """A rank's process: its arguments come pickled on standard input."""
    parent = os.getppid()
    _die_with_parent()
    if os.getppid() != parent:  # the launcher died before the death signal was set
        sys.exit(1)
    args = pickle.loads(sys.stdin.buffer.read())
    sys.exit(_worker(*args))


def _descendants(pid):
    """The pids below ``pid`` (from /proc; empty where there is none)."""
    parents = {}
    for entry in Path("/proc").iterdir() if Path("/proc").is_dir() else ():
        if entry.name.isdigit():
            try:
                stat = (entry / "stat").read_text()
                parents.setdefault(int(stat.rsplit(")", 1)[1].split()[1]), []).append(
                    int(entry.name))
            except (OSError, ValueError, IndexError):
                pass
    found, todo = [], [pid]
    while todo:
        kids = parents.get(todo.pop(), [])
        found += kids
        todo += kids
    return found


def _signal(pids, sig):
    for pid in pids:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def _stop(procs):
    """Ends every rank still running and whatever it started, and waits."""
    live = [p for p in procs if p.poll() is None]
    below = [d for p in live for d in _descendants(p.pid)]
    _signal([p.pid for p in live] + below, signal.SIGTERM)
    deadline = time.monotonic() + STOP_GRACE_S
    for p in live:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    _signal([p.pid for p in live if p.poll() is None] + below, signal.SIGKILL)
    for p in live:
        p.wait()
    for pid in below:  # reaped by init once orphaned; wait until each is gone
        while os.path.exists(f"/proc/{pid}") and time.monotonic() < deadline + STOP_GRACE_S:
            time.sleep(0.05)


def _code(returncode):
    return 128 - returncode if returncode < 0 else returncode


def launch(cell, seed, seconds, trace_on, t_process, device="cuda", fault=None):
    """Runs the cell on ``cell.chips`` ranks -> the exit code. ``fault``
    (tests only) is planted in every rank (``faults.plant``)."""
    port = _free_port()
    procs = []
    old = signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    try:
        for rank in range(cell.chips):
            p = subprocess.Popen([sys.executable, "-c", CHILD], cwd=ROOT, stdin=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((rank, port, cell, seed, seconds, trace_on,
                                        t_process, device, fault)))
            p.stdin.close()
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs):  # a rank failed: the others would wait
                break
            time.sleep(0.2)
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, old)
    return next((_code(p.returncode) for p in procs if p.returncode), 0)
