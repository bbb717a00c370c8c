"""Hang-detection watchdog (counterpart of recsys_examples_tpu/utils/watchdog.py):
dumps all-thread stacks if a training iteration exceeds a timeout, then
keeps watching."""
from __future__ import annotations

import faulthandler
import io
import sys
import threading
import traceback
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


class StackDumpWatchdog:
    def __init__(self, timeout_s: float = 60.0, repeat: bool = True):
        self.timeout_s = timeout_s
        self.repeat = repeat
        self._timer = None

    def _fire(self):
        sys.stderr.write(
            f"\n[watchdog] iteration exceeded {self.timeout_s}s — "
            "dumping all thread stacks\n"
        )
        # faulthandler needs a real file descriptor; pytest's captured
        # stderr (and any io.StringIO) has none — fall back to the pure-
        # Python formatter rather than crashing while firing.
        try:
            sys.stderr.fileno()
        except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
            frames = sys._current_frames()
            for tid, frame in frames.items():
                sys.stderr.write(f"\n[watchdog] Thread {tid}:\n")
                sys.stderr.write("".join(traceback.format_stack(frame)))
        else:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        if self.repeat:
            self.reset()

    def reset(self):
        self.cancel()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def watched_iter(
    it: Iterable[T], timeout: float = 60.0
) -> Iterator[T]:
    """Wrap an iterator; each step must complete within `timeout` seconds or
    stacks are dumped."""
    wd = StackDumpWatchdog(timeout)
    wd.reset()
    try:
        for item in it:
            yield item
            wd.reset()
    finally:
        wd.cancel()
