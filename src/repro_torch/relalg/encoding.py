"""Host-side dictionary encoding.

Strings (and arbitrary hashable values) never live on device. A ``Vocab``
interns every value appearing in a source to a dense int32 id; all device
relational work happens on the ids. This mirrors the paper's observation that
comparisons in the relational model are cheaper than over RDF terms — here we
go further and make every device comparison an int32 vector compare.

Ids are allocated densely from 0; the fill/pad sentinel is INT32_MAX, so
``intern`` asserts we stay far away from it.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Iterable, List

import numpy as np

PAD_ID = np.int32(2**31 - 1)  # sentinel for invalid/padding rows; sorts last
MAX_ID = 2**31 - 2


class Vocab:
    """Bidirectional value <-> int32 id mapping (host side)."""

    def __init__(self) -> None:
        self._to_id: Dict[Hashable, int] = {}
        self._to_value: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._to_value)

    def copy(self) -> "Vocab":
        """A vocab of its own with the same ids (values are shared: they
        are immutable), so two sessions can grow apart from one DIS."""
        out = Vocab()
        out._to_id = dict(self._to_id)
        out._to_value = list(self._to_value)
        return out

    def truncate(self, n: int) -> None:
        """Forget every id ``>= n``: the rollback of values interned for
        rows that were then dropped (a mesh front door's skipped flush),
        so the ids stay equal to every other rank's."""
        for value in self._to_value[n:]:
            del self._to_id[value]
        del self._to_value[n:]

    def intern(self, value: Hashable) -> int:
        vid = self._to_id.get(value)
        if vid is None:
            vid = len(self._to_value)
            if vid > MAX_ID:
                raise OverflowError("Vocab exhausted int32 id space")
            self._to_id[value] = vid
            self._to_value.append(value)
        return vid

    def intern_many(self, values: Iterable[Hashable]) -> np.ndarray:
        return np.asarray([self.intern(v) for v in values], dtype=np.int32)

    def decode(self, vid: int) -> Any:
        if vid == PAD_ID:
            return None
        return self._to_value[int(vid)]

    def decode_many(self, ids: np.ndarray) -> List[Any]:
        return [self.decode(i) for i in np.asarray(ids).reshape(-1)]

    def __contains__(self, value: Hashable) -> bool:
        return value in self._to_id

    def lookup(self, value: Hashable) -> int:
        """Id for an existing value (KeyError if never interned)."""
        return self._to_id[value]
