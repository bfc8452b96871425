"""Training progress / ETA reporting: a copy of the JAX package's
``utils/progress.py`` (the port imports nothing of that package).

Rebuild of the reference progress bar (``xpysom_dask/xpysom.py:47-69``)
without the module-global timer state: ``ProgressReporter`` is an object so
concurrent trainings don't clobber each other's clocks. Output format is
identical: ``[ t / T ] p% - <elapsed> elapsed - <left> left``.
"""

from __future__ import annotations

from datetime import timedelta
from sys import stdout
from time import time

__all__ = ["ProgressReporter"]


class ProgressReporter:
    def __init__(self, total: int):
        self.total = total
        self.digits = len(str(total))
        self.beginning = None

    def start(self):
        self.beginning = time()
        stdout.write(
            "\r [ {s:{d}} / {T} ] {s:3.0f}% - ? it/s".format(
                T=self.total, d=self.digits, s=0
            )
        )

    def update(self, t: int):
        if self.total <= 0 or t < 0:
            # empty dataset (total = epochs·0 rows) or a pre-start tick:
            # nothing meaningful to report, and t+1 == 0 would divide by
            # zero below (review r4)
            return
        if self.beginning is None:
            self.start()
        elapsed = time() - self.beginning
        # (total - t + 1), not (total - (t+1)): the ETA over-counts two
        # work units and reports nonzero time left at 100% — deliberate
        # observable-behavior parity with the reference's print_progress
        # (xpysom.py:61), like the bar format itself.
        sec_left = ((self.total - t + 1) * elapsed) / (t + 1)
        time_left = str(timedelta(seconds=sec_left))[:7]
        time_elapsed = str(timedelta(seconds=elapsed))[:7]
        progress = "\r [ {t:{d}} / {T} ]".format(t=t + 1, d=self.digits, T=self.total)
        progress += " {p:3.0f}%".format(p=100 * (t + 1) / self.total)
        progress += " - {} elapsed ".format(time_elapsed)
        progress += " - {} left ".format(time_left)
        stdout.write(progress)
