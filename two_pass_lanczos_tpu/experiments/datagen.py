"""Instance-generation CLI (reference ``src/bin/datagen.rs``).

Same flags and the same ``netgen-{arcs}-{rho}-{id}-{cf}-{cq}-{s}`` naming
convention (reference ``datagen.rs:68-90,109-117``). Prefers the native C++
pipeline (``cpp/mcfgen``: the pargen → netgen → qfcgen equivalent, one
binary); falls back to the deterministic Python generator when the native
tool is not built. Both produce the same format; the Python generator is the
oracle for the C++ one (validated in tests).
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NATIVE = REPO / "cpp" / "mcfgen"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arcs", type=int, required=True, help="number of arcs m")
    p.add_argument("--rho", type=int, choices=[1, 2, 3], required=True,
                   help="density parameter (prho = 0.25/0.5/0.75)")
    p.add_argument("--instance-id", type=int, default=1, help="instance seed id")
    p.add_argument("--fixed-cost", choices=["a", "b"], default="a",
                   help="cf: high (a) or low (b) fixed costs")
    p.add_argument("--quadratic-cost", choices=["a", "b"], default="a",
                   help="cq: high (a) or low (b) quadratic costs")
    p.add_argument("--scaling", choices=["s", "ns"], default="ns",
                   help="capacity scaling by 0.7 (s) or none (ns)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--python", action="store_true",
                   help="force the Python generator even if cpp/mcfgen exists")
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu.experiments.common import log, setup_cli
    from two_pass_lanczos_tpu.models.generator import instance_basename

    args = build_parser().parse_args(argv)
    setup_cli()
    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    base = instance_basename(args.arcs, args.rho, args.instance_id,
                             args.fixed_cost, args.quadratic_cost, args.scaling)

    if NATIVE.exists() and not args.python:
        cmd = [str(NATIVE), str(args.arcs), str(args.rho), str(args.instance_id),
               args.fixed_cost, args.quadratic_cost, args.scaling, str(outdir)]
        log.info("running native generator: %s", " ".join(cmd))
        subprocess.run(cmd, check=True)
    else:
        from two_pass_lanczos_tpu.models.generator import generate_mcf_instance

        log.info("running python generator")
        generate_mcf_instance(
            args.arcs, rho=args.rho, instance_id=args.instance_id,
            cf=args.fixed_cost, cq=args.quadratic_cost, scaling=args.scaling,
            output_dir=outdir,
        )

    for ext in (".dmx", ".qfc"):
        f = outdir / f"{base}{ext}"
        if not f.exists():
            raise SystemExit(f"expected output {f} missing")
        log.info("generated %s (%d bytes)", f, f.stat().st_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
