"""Child processes that die with the process that started them.

A driver that runs a command in a process of its own (``probes/
gate_sweep.py``'s validate rows, ``probes/variance10.py``'s cross-process
runs) starts it through :func:`run`: on Linux the kernel kills the child
when its parent ends (``PR_SET_PDEATHSIG``), so that a killed driver
leaves no render running on the card.
"""

from __future__ import annotations

import ctypes
import os
import signal
import subprocess
import sys

PR_SET_PDEATHSIG = 1
# Resolved here, not in the forked child, which runs as little Python as
# it can before its exec.
_PRCTL = ctypes.CDLL(None).prctl if sys.platform.startswith("linux") else None


def _die_with(parent: int):
    def preexec() -> None:
        if _PRCTL is not None:
            _PRCTL(PR_SET_PDEATHSIG, signal.SIGKILL)
        if os.getppid() != parent:      # the parent ended before the prctl
            os._exit(1)

    return preexec


def run(cmd, *, timeout: float, **kwargs) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, timeout=timeout, **kwargs)`` of a child that
    dies with this process; past ``timeout`` seconds it is killed and
    ``subprocess.TimeoutExpired`` raised."""
    return subprocess.run(cmd, timeout=timeout,
                          preexec_fn=_die_with(os.getpid()), **kwargs)
