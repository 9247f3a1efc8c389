"""Preemption-tolerant training: SIGTERM -> checkpoint -> clean exit (the
port's copy of ``vit_ed_tpu/utils/preempt.py``).

A scheduler that preempts a job sends SIGTERM and waits a short grace
window before it kills the process. ``PreemptionGuard`` turns the signal
into a flag; the trainer polls ``should_stop(step)`` after every optimizer
update, and on True saves a mid-epoch checkpoint (``in_epoch_opt_steps``)
and returns, so that a rerun continues the same epoch from that update.

One process: the answer is the local flag. Several processes: SIGTERM
reaches each rank on its own time (rank A may see it during update k, rank
B during k + 1, or never), but every rank must save at the same update and
stop. So the guard never acts on the local flag alone: at each cadence
every rank contributes its flag to an all-gather of one int over the
host (gloo) group, and all of them stop if any flagged. The cadence is
aligned by construction: every rank runs the same number of updates and
calls ``should_stop`` after each. As in the JAX guard, the agreement is one
cadence lagged: each call starts this cadence's gather (``async_op=True``)
and reads the previous cadence's result, so the host never waits on a
gather that was just posted. All ranks read the same gather at the same
cadence index, so they agree exactly; the first call reads its own.
"""

from __future__ import annotations

import signal
import threading

import torch

from vit_ed_tpu_torch.parallel import mesh

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Install with :meth:`install` (main thread only); poll with
    :meth:`should_stop` after every optimizer update."""

    def __init__(self, check_freq: int = 1):
        self.check_freq = max(int(check_freq), 1)
        self._flag = threading.Event()
        self._prev = None
        self._installed = False
        self._pending = None   # the posted gather: (work, outputs)

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
        """Put back the handler that was there before :meth:`install`, and
        finish the gather still posted (every rank posted it)."""
        if self._pending is not None:
            self._pending[0].wait()
            self._pending = None
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

    def _dispatch(self):
        """Post this rank's flag into an all-gather without waiting."""
        flag = torch.tensor([int(self._flag.is_set())], dtype=torch.int32)
        out = [torch.zeros_like(flag) for _ in range(mesh.process_count())]
        work = torch.distributed.all_gather(out, flag, group=mesh._host_group(),
                                            async_op=True)
        return work, out

    def should_stop(self, step: int) -> bool:
        """Whether to save and stop after update ``step``, on steps that
        are multiples of ``check_freq`` (False between, with no
        communication). One process: the local flag. Several: whether any
        rank had flagged at the previous cadence (at the first, at this
        one); every rank calls it with the same ``step`` sequence."""
        if step % self.check_freq:
            return False
        if mesh.process_count() == 1:
            return self._flag.is_set()
        if self._pending is None:
            self._pending = self._dispatch()
        (work, out), self._pending = self._pending, self._dispatch()
        work.wait()
        return any(int(t.item()) for t in out)
