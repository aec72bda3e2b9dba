"""Graceful preemption for the trainers (the port of
fac_via_ppg_tpu/train/preemption.py), one process.

A scheduler announces an eviction with SIGTERM shortly before it reclaims
the machine.  `PreemptionGuard` records the signal; the epoch loops poll
`should_stop()` once per iteration, then write a final checkpoint and
return, so that `checkpoint_path='auto'` resumes with no work lost."""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Installs a SIGTERM handler; trainers poll `should_stop()`.

    Off the main thread, where CPython installs no handler, the guard is
    inert (signals untouched) and `request()` still works."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._installed = {}
        try:
            for s in signals:
                self._installed[s] = signal.signal(s, self._on_signal)
        except ValueError:
            # not the main thread: restore whatever did install
            self.uninstall()

    def _on_signal(self, signum, frame):
        del frame
        print(f"Preemption notice (signal {signum}): finishing the current "
              "iteration, then saving a final checkpoint and exiting "
              "cleanly", flush=True)
        self._flag.set()

    def request(self):
        """Programmatic preemption (tests, embedding frameworks)."""
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def should_stop(self) -> bool:
        """The per-iteration poll."""
        return self.requested

    def uninstall(self):
        """Restore the previous handlers."""
        for s, prev in self._installed.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._installed = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False
