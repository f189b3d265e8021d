"""Experiment CLIs reproducing the reference's six binaries.

Reference parity (``src/bin/``): ``tradeoff``, ``dense_tradeoff``,
``scalability``, ``stability``, ``orthogonality``, ``datagen`` — identical
CSV schemas (column-for-column with the published ``results/*.csv``), clap-
style flags mapped to argparse, and the orchestrator/worker process-isolation
model available via ``--isolate`` where peak-RSS fidelity matters
(``src/bin/tradeoff.rs:4-7``). On an accelerator the memory metric is PJRT
device memory (``device_peak_kb``).

Run as ``python -m two_pass_lanczos_tpu.experiments.<name> --help``.
"""
