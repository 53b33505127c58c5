"""Process and file-descriptor diagnostics (port of the JAX package's
``utils.monitor``), the counterpart of the reference's psutil fd-leak
monitor: the fds, open files, threads, RSS and CPU share of every live
python process. psutil is imported at first use; without it each
function raises an ImportError that names it.
"""

from __future__ import annotations

from typing import Any


def _psutil():
    try:
        import psutil
    except ImportError as e:
        raise ImportError("the process monitor needs psutil, which is not "
                          "installed") from e
    return psutil


def find_python_processes() -> list[Any]:
    """Every live process whose name holds "python"."""
    psutil = _psutil()
    procs = []
    for p in psutil.process_iter(["name", "pid", "ppid"]):
        try:
            if "python" in (p.info["name"] or ""):
                procs.append(p)
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue
    return procs


def _open_files(proc: Any) -> int | None:
    """The count of regular files ``proc`` holds open; None where psutil
    cannot parse the process's ``/proc/<pid>/fdinfo`` entries (a kernel
    whose fdinfo lacks the ``flags`` line makes its parser raise
    IndexError)."""
    try:
        return len(proc.open_files())
    except (IndexError, ValueError):
        return None


def process_summary(proc: Any) -> dict:
    """The process's fd, file, thread, RSS and CPU figures (JAX's keys);
    ``{"pid", "error"}`` for a process that is gone or not readable."""
    psutil = _psutil()
    try:
        with proc.oneshot():
            return {
                "pid": proc.pid,
                "ppid": proc.ppid(),
                "name": proc.name(),
                "num_fds": proc.num_fds(),
                "open_files": _open_files(proc),
                "threads": proc.num_threads(),
                "rss_mb": proc.memory_info().rss / 1e6,
                "cpu_percent": proc.cpu_percent(interval=None),
            }
    except (psutil.NoSuchProcess, psutil.AccessDenied):
        return {"pid": proc.pid, "error": "gone"}


def print_python_processes(verbose: bool = False) -> list[dict]:
    """Print each python process's fd and memory figures; returns the
    records."""
    records = [process_summary(p) for p in find_python_processes()]
    for r in records:
        if "error" in r:
            continue
        files = "?" if r["open_files"] is None else r["open_files"]
        line = (f"pid={r['pid']} ppid={r['ppid']} fds={r['num_fds']} "
                f"open_files={files} rss={r['rss_mb']:.0f}MB")
        if verbose:
            line += f" threads={r['threads']} cpu={r['cpu_percent']:.0f}%"
        print(line)
    return records


def fd_count() -> int:
    """This process's fd count."""
    return _psutil().Process().num_fds()
