"""fgbench: the benchmark of tpufg_torch (the PyTorch and CUDA port) on
one NVIDIA H100.  ``python3 fgbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell named in ``BENCHMARK.json``;
nothing here imports ``jax`` or ``tpufg``, and ``fgbench/reference/``
imports nothing of ``tpufg_torch`` either."""
