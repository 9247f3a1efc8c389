"""Preemption-tolerant training: SIGTERM -> checkpoint -> clean exit (the
port's copy of ``vit_ed_tpu/utils/preempt.py``).

A scheduler that preempts a job sends SIGTERM and waits a short grace
window before it kills the process. ``PreemptionGuard`` turns the signal
into a flag; the trainer polls ``should_stop(step)`` after every optimizer
update, and on True saves a mid-epoch checkpoint (``in_epoch_opt_steps``)
and returns, so that a rerun continues the same epoch from that update.

One process: the answer is the local flag. The JAX guard all-gathers every
process's flag at each cadence so that all processes save together; the
port trains in one process (several processes are ROADMAP queue A item 7),
so there is nothing to agree with yet, and the guard has no
``torch.distributed`` path.
"""

from __future__ import annotations

import signal
import threading

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install with :meth:`install` (main thread only); poll with
    :meth:`should_stop` after every optimizer update."""

    def __init__(self, check_freq: int = 1):
        self.check_freq = max(int(check_freq), 1)
        self._flag = threading.Event()
        self._prev = None
        self._installed = False

    def install(self) -> "PreemptionGuard":
        """Register the SIGTERM handler. Off the main thread (where CPython
        does not register handlers) this is a no-op: the guard then trips
        only through :meth:`signal`."""
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:
            self._prev = None
        return self

    def uninstall(self) -> None:
        """Put back the handler that was there before :meth:`install`."""
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
            self._installed = False

    def _handler(self, signum, frame):
        self._flag.set()
        prev = self._prev
        if callable(prev):   # chain a handler that was there before
            try:
                prev(signum, frame)
            except (KeyboardInterrupt, SystemExit, Exception):
                # a previous handler that raises or exits must not kill the
                # process before the checkpoint is written
                pass

    def signal(self) -> None:
        """Trip the flag without a signal (tests, an external poller)."""
        self._flag.set()

    @property
    def preempted_locally(self) -> bool:
        return self._flag.is_set()

    def should_stop(self, step: int) -> bool:
        """Whether to save and stop after update ``step``: the flag, read
        on steps that are multiples of ``check_freq`` (False between)."""
        if step % self.check_freq:
            return False
        return self._flag.is_set()
