"""Graceful-preemption handling for long training runs, this package's own
copy of plr2_tpu/utils/interrupt.py (it imports nothing of a framework).

Preemptible VMs and batch schedulers deliver SIGTERM with a short
grace window before the host disappears. The reference has no failure
detection — it restarts only via manual ``--resume_*`` flags reloading
``.pth`` files (upstream tools/train.py; SURVEY.md section 5.3). Here a
``GracefulInterrupt`` context installed by ``plr2_tpu_torch/tools/train.py`` turns the
first SIGTERM/SIGINT into a *request*: ``Trainer.fit`` notices it at the
next sample/batch boundary, abandons the partial epoch (no partial
optimizer step is applied), saves the state under the ``last`` tag, and
returns — so the existing auto-resume replays at most the interrupted
epoch. A second signal escalates to an immediate ``KeyboardInterrupt``
for runs that are stuck inside a long compile or device call.
"""

from __future__ import annotations

import signal
from typing import Iterable


class GracefulInterrupt:
    """Context manager: latch the first SIGTERM/SIGINT into a flag.

    Usable directly as a ``stop_fn`` callable (``bool(stop)`` /
    ``stop()`` both report whether an interrupt was requested). Handlers
    are installed on ``__enter__`` and the previous ones restored on
    ``__exit__``; ``request()`` sets the flag programmatically (tests,
    cooperative schedulers).
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous = {}
        self._requested = False

    # -- flag interface -------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._requested

    def request(self) -> None:
        self._requested = True

    def __bool__(self) -> bool:
        return self._requested

    def __call__(self) -> bool:
        return self._requested

    # -- signal plumbing ------------------------------------------------
    def _handle(self, signum, frame):
        if self._requested:
            # second signal: the user/scheduler means it — stop now even
            # if we're inside a long device call
            raise KeyboardInterrupt(
                f"second signal {signal.Signals(signum).name} during "
                "graceful shutdown")
        self._requested = True

    def __enter__(self) -> "GracefulInterrupt":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return None
