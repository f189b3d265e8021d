"""Collective-traffic audit: what a compiled distributed solve moves per step.

The collective traffic of the distributed design is read from the
**compiled HLO** on a virtual CPU mesh — the collective instructions XLA
actually emits (op kind, tensor shape, byte size), which are facts about
the mesh, independent of the executing backend. Collectives inside a
`while` body execute once per Lanczos step, so static instances map 1:1 to
per-step traffic. See `scripts/collective_audit.py` for the table and
`tests/test_collectives.py` for the pinned invariants.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List

__all__ = ["CollectiveOp", "collectives_in_hlo", "collective_bytes"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8}

_SHAPE_RE = re.compile(r"=\s*(?:\()?\s*(\w+)\[([\d,]*)\]")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str  # e.g. "all-gather"
    dtype: str
    shape: tuple
    count: int

    @property
    def bytes_out(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _DTYPE_BYTES.get(self.dtype, 4) * self.count


def collectives_in_hlo(hlo_text: str) -> List[CollectiveOp]:
    """Parse collective instructions (kind, output dtype/shape, count) out of
    a compiled HLO module's text. Tuple-shaped outputs report the first
    element (XLA's combined collectives); `-start/-done` pairs are counted
    once (on the `-start`)."""
    found = {}
    for line in hlo_text.splitlines():
        for kind in _COLLECTIVES:
            if f"{kind}(" in line or f"{kind}-start(" in line:
                m = _SHAPE_RE.search(line)
                if not m:
                    continue
                dtype = m.group(1)
                shape = tuple(int(x) for x in m.group(2).split(",") if x)
                key = (kind, dtype, shape)
                found[key] = found.get(key, 0) + 1
    return [CollectiveOp(kind=k, dtype=d, shape=s, count=c)
            for (k, d, s), c in sorted(found.items())]


def collective_bytes(ops: List[CollectiveOp], kinds=None) -> int:
    """Total output bytes across (optionally a subset of) collective ops."""
    return sum(o.bytes_out for o in ops
               if kinds is None or o.kind in kinds)
