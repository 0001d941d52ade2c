"""The paper's own workload: the §4 experimental grid, as a config.

Group A: 4 volumes x 3 redundancy levels x 2 engines x 2 frameworks.
Group B: join experiments with 0/1/2 sources pre-deduplicated.
Row counts are scaled-down but keep the paper's ratios; a run may scale
them toward the paper's 19.5M records. Not routed through ``get_config``,
which serves the language-model architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    # group A grid (fractions of the full dataset, per the paper)
    volumes: Sequence[float] = (0.25, 0.50, 0.75, 1.00)
    redundancies: Sequence[float] = (0.25, 0.50, 0.75)
    engines: Sequence[str] = ("rmlmapper", "sdm")
    base_rows: int = 20000          # rows at volume=1.0 (scaled testbed)
    n_noise_attrs: int = 8          # wide-source shape (paper: up to 39)
    timeout_seconds: float = 500.0  # the paper's timeout

    # group B
    group_b_rows: int = 8000
    group_b_redundancy: float = 0.75
    group_b_scenarios: Tuple[Tuple[bool, bool], ...] = (
        (False, False),   # (a) no dedup
        (True, False),    # (b) one source dedup'd
        (True, True),     # (c) both dedup'd
    )

    def rows_for_volume(self, v: float) -> int:
        return max(1, int(round(self.base_rows * v)))


CONFIG = PaperConfig()
