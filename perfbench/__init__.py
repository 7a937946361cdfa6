"""The benchmark of ``deeptables_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: its configuration
(``configs/<config>.json``) and the nets it names (``nets/<net>.py``), its
traffic mix (``traffic/<mix>.json``, run by ``drivers/<driver>.py``), the
limits of its correctness check (``limits/<cell>.json``) and, in a traced
run, its per-layer metrics (``metrics/<metric>.py``), each found by its
name.
"""
