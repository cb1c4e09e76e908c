"""End-to-end benchmark of hsearch_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells, each a
configuration (a deployment: data scale, radius, engine settings) under a
traffic mix.  Everything else is found by name (``registry.py``):

    configs/<config>.json          sizes, engine, the limits of ``correct``
    traffic/<traffic>.json         parameters the one generator reads
    engines/<engine>.py            set-up of the system under test and one
                                   batch call (``make``)
    layer_metrics/<metric>.py      one per-layer metric's reader (``read``)

The yardstick lives here and nowhere in the program: the data generator
(``workload.py``), the plain reference (``reference.py``, plain PyTorch,
importing nothing of the port), the comparison that decides ``correct``
(``judge.py``), the recall arithmetic (``recall.py``), the trace reduction
(``devtrace.py``) and the peaks and work counts (``roofline.py``).
Nothing here imports ``jax`` or the JAX package ``hsearch_tpu``.
"""
