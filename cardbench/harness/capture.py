"""A seeded sample of what the window produced, kept for the check after
it closes (reservoir sampling: each item offered while `active` is kept
with the same chance, whatever the window's length)."""
from __future__ import annotations

from typing import Any, List

import numpy as np


class Sample:
    def __init__(self, k: int, rng: np.random.Generator):
        self.k = int(k)
        self.rng = rng
        self.items: List[Any] = []
        self.seen = 0
        self.active = False

    def offer(self, item: Any) -> None:
        if not self.active:
            return
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item
