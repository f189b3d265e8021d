#!/usr/bin/env python3
"""Overlay the double-float accuracy grid on the CPU-f64 oracle.

One 2x2 figure (exp/inv x well/ill): each panel shows the two-pass relative
error vs k from ``accuracy_<f>_<cond>-conditioned.csv`` (CPU f64, the oracle)
and ``accuracy_<f>_<cond>-conditioned_tpu_df.csv`` (the same sweep through
the double-float path, f32 arithmetic, identical seed-42 b). The curves
coinciding is REPORT.md section 1's "f64-class from f32" claim, as a picture.

Counterpart artifact to the reference's per-scenario stability plots
(reference ``python/plot_stability.py``); the df overlay has no reference
equivalent (the reference is f64-native).

Usage: plot_df_accuracy.py [results_dir] [out.pdf]
"""

import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd

sys.path.insert(0, str(Path(__file__).parent))
from plot_common import style_axes

SCENARIOS = [
    ("exp", "well"), ("exp", "ill"),
    ("inv", "well"), ("inv", "ill"),
]


def main(results_dir: str = "results", out_path: str | None = None) -> int:
    results = Path(results_dir)
    out_path = out_path or str(results / "images" / "accuracy_df_overlay.pdf")

    fig, axes = plt.subplots(2, 2, figsize=(10.5, 8.0), constrained_layout=True)
    for ax, (fn, cond) in zip(axes.flat, SCENARIOS):
        f64 = pd.read_csv(results / f"accuracy_{fn}_{cond}-conditioned.csv")
        df = pd.read_csv(results / f"accuracy_{fn}_{cond}-conditioned_tpu_df.csv")
        # the f64 inv/ill sweep extends past the df grid; compare on shared k
        f64 = f64[f64["k"] <= df["k"].max()].sort_values("k")
        df = df.sort_values("k")
        ax.semilogy(f64["k"], f64["relative_error_two_pass"], marker="o",
                    markersize=4, linewidth=2, color="#1b6ca8",
                    label="CPU f64 (oracle)")
        ax.semilogy(df["k"], df["relative_error_two_pass"], marker="s",
                    markersize=4, linewidth=1.5, linestyle="--",
                    color="#c2571a", label="double-float")
        style_axes(ax, "Lanczos iterations k", "Relative error (two-pass)",
                   f"{fn} / {cond}-conditioned")
        ax.legend(frameon=False, fontsize=9)

    fig.savefig(out_path)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
