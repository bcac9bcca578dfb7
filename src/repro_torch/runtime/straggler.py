"""Straggler detection: robust per-step timing statistics (copy of
``repro.runtime.straggler``).

On a real pod a straggling host shows up as a slow step for *everyone*
(collectives synchronize).  Detection is a prerequisite for mitigation
(re-shard around the slow host, re-issue input pipeline work, alert).  We
use a median/MAD window — robust to the compile-step outlier and to drift —
and expose a hook for the runner's mitigation policy.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["StragglerDetector"]


class StragglerDetector:
    def __init__(self, window: int = 50, threshold: float = 4.0, warmup: int = 3):
        self.window = deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self.events: list[tuple[int, float, float]] = []

    def record(self, step: int, seconds: float) -> str | None:
        """Returns a description if this step is anomalous, else None."""
        if len(self.window) >= self.warmup:
            med = float(np.median(self.window))
            mad = float(np.median(np.abs(np.asarray(self.window) - med))) or med * 0.05
            if seconds > med + self.threshold * mad and seconds > 1.5 * med:
                self.events.append((step, seconds, med))
                self.window.append(seconds)
                return f"{seconds*1e3:.1f} ms vs median {med*1e3:.1f} ms"
        self.window.append(seconds)
        return None

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0
