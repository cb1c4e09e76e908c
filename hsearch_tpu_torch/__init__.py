"""hsearch_tpu_torch — the PyTorch/CUDA port of hsearch_tpu for NVIDIA Hopper.

Each module keeps the name and place of its counterpart in ``hsearch_tpu``
(the JAX package, which stays the reference the port is tested against):

  core/        alphabet, BLOSUM62, metric embedding, FASTA/datapoints IO
  ops/         distances, packed hit transfer, hand-written CUDA kernels
               (csrc/*.cu, built with nvcc at first use)
  search/      exact oracle, block-pruned IVF engine, recall evaluation
  utils/       index checkpointing (the ``ivf`` .npz kind)
  cli          ``python -m hsearch_tpu_torch motif-search[-exact]``

The port imports torch and numpy only — never jax, never hsearch_tpu.
Every entry point takes ``device`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller asked for ``"cpu"``.
"""

__version__ = "0.1.0"
