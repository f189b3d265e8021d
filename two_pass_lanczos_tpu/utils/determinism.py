"""Keep XLA's GPU reductions the same from one compilation to the next.

XLA's fusion autotuner times its native emitter against a Triton one for
each small reduction and keeps the faster. The two sum in different
orders, and the choice can flip from one compilation to the next, so two
programs that run the same recurrence (the one-pass and the two-pass
solve, or a program and its copy from the persistent compile cache) can
round α and β differently. On an H100 the pass-one α of two such programs
first differed at step 12, and the two solves at 500k arcs, k=500, then
differed by 2.3e-10 instead of 1e-15. With the autotuner off, XLA picks the
emitter by a fixed rule and every compilation of a program sums in the
same order.

XLA reads ``XLA_FLAGS`` once, when JAX first initialises a backend, so the
package sets the flag when it is imported; a process that used the GPU
before importing it keeps the autotuner.
"""

from __future__ import annotations

import os
from typing import MutableMapping

__all__ = ["FUSION_AUTOTUNER_FLAG", "pin_fusion_emitters"]

FUSION_AUTOTUNER_FLAG = "xla_gpu_experimental_enable_fusion_autotuner"


def pin_fusion_emitters(environ: MutableMapping[str, str] = os.environ) -> bool:
    """Turn the fusion autotuner off in ``XLA_FLAGS`` unless the flag is
    already set there either way; return whether it was added."""
    flags = environ.get("XLA_FLAGS", "")
    if FUSION_AUTOTUNER_FLAG in flags:
        return False
    environ["XLA_FLAGS"] = f"{flags} --{FUSION_AUTOTUNER_FLAG}=false".strip()
    return True
