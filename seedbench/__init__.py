"""seedbench: the benchmark of psi_tpu_torch's seed finding on one card.

`python3 -m seedbench.run --workload NAME --seed N --seconds S --trace 0|1`
runs one cell of BENCHMARK.json once and prints one JSON result line.
Everything a cell needs is found by name: its configuration in
configs/<name>.json, its traffic mix in traffic/<name>.json, the entry
that drives it in entries/<kind>.py and each metric's reader in
metrics/<metric>.py. The yardstick lives here too: the frozen input
generators (gen.py), the plain reference that decides `correct`
(reference.py), the byte counts and peaks of the rooflines (roofline.py)
and the reduction of the profiler's trace (trace.py). None of those
imports the program; only the entries and the readers of the program's
own spans touch psi_tpu_torch.
"""
