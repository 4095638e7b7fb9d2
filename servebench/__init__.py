"""The serving benchmark of `repro_torch` on an NVIDIA H100.

Run one cell from the root of a checkout:

    python3 servebench/run.py --workload granite-8b.reasoning --seed 7 \
        --seconds 45 --trace 0

Everything a cell uses is found by name: the cell in BENCHMARK.json, its
configuration in `configs/<config>.json`, its traffic mix in
`traffic/<mix>.json`, each per-layer metric's reader in
`metrics/<metric>.py`, and the limit of its correctness check in
`limits/<workload>.json`. The plain references are in `reference/`.
"""
