"""Benchmark of pyopal_tpu_torch on an NVIDIA card.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix): ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  The modules
here hold the yardstick: data and query generation from the seed
(`generate`), the plain Smith-Waterman reference (`reference`), the
comparison that decides ``correct`` (`check`), the trace reduction
(`trace`), the peaks and the arithmetic of rates and rooflines
(`peaks`), and the run itself (`harness`).  Configurations, traffic
mixes and metric readers are files under ``configs/``, ``traffic/`` and
``metrics/``, found by the names in ``BENCHMARK.json``.
"""
