"""The benchmark of the PyTorch and CUDA port (``color_transfer_tpu_torch``).

One run: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout. The cells are the
``workloads`` of ``BENCHMARK.json``; each names a configuration
(``configs/<name>.json``, with its plain reference in ``reference/``) and a
traffic mix (``traffic/<name>.json``, read by ``traffic.py``). Each
per-layer metric is a reader of its own (``metrics/<name>.py``), and each
cell's output limits sit in ``limits/<cell>.json``. Nothing here imports
JAX or the JAX package, and ``reference/`` imports nothing of the port.
"""
