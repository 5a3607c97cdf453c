"""The benchmark of the PyTorch and CUDA port (``color_transfer_tpu_torch``).

One run: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout. The cells are the
``workloads`` of ``BENCHMARK.json``; each names a configuration (the file
its ``configs`` entry names, ``configs/<name>.json``, with its plain
reference in ``reference/``) and a traffic mix (``traffic/<name>.json``,
read by ``traffic.py``). Each per-layer metric is a reader of its own
(``metrics/<name>.py``); each cell's output limits sit in
``limits/<cell>.json`` and its FLOPs a frame or step in
``flops/<cell>.json``. Nothing here imports JAX or the JAX package, and
``reference/`` imports nothing of the port.

A configuration or a traffic enters as new files and new entries in
``BENCHMARK.json`` only:

  * a configuration: ``configs/<name>.json`` (the port's ``method``,
    ``module`` and ``kwargs``; ``reference``, ``sizes`` and ``init`` for
    the reference and the weights; ``capture``, {submodule: [output, ...]},
    the serving outputs checked beside the corrected frame, which may be
    empty; ``lower_precision_kwargs``, the port's own lower-precision
    recipe, which the CPU tests put in the program's place; ``reduced`` and
    each reduced key's published value under ``published``), its reference
    ``reference/<reference>.py`` (``build``, and ``serve`` -> (corrected
    frame, {output: tensor}) or ``train_loss`` and ``trainable``; for
    serving, ``SERVE_OUTPUTS``, {number: (output, rule of
    ``serve.RULES``)}, the outputs compared where captured), and the
    ``configs`` entry;
  * a traffic: ``traffic/<name>.json`` of a kind ``traffic.py`` reads;
  * a cell: the ``workloads`` entry, ``limits/<cell>.json`` (set by
    ``calibrate``'s readings), ``flops/<cell>.json`` ({per, shape, flops},
    counted by ``peaks.reference_flops``) and the cell's name in the
    ``workloads`` of each metric it reports. The faults its tests plant
    follow from its kind and chips (``faults.of``).
"""
