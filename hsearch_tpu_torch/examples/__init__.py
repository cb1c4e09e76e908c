"""Measurement and worked-example scripts of the port, one for each of the
JAX package's ``examples/`` scripts, with the same name, workload and
output rows:

    python -m hsearch_tpu_torch.examples.<name> [arguments] [--device cpu]

  bench_engines      LSH, IVF, greedy and centroid clustering rows
  bench_stream       a large query batch through ivf.search
  quickstart         FASTA -> k-mers -> engines -> clusters -> pcluster
  pipeline_e2e       the IGC-shaped CLI pipeline, timed per stage
  bench_align        search_all and cluster_proteins proteins/s
  bench_pcluster_mp  pcluster_dist over N local processes
  bench_gapped       cluster_proteins gapped=True against False
  sweep_klsh         KLSH bits x sigma against family-pair recall
  bench_merge_scale  greedy alone against greedy + the center merge
  bench_stream27     the segmented index under resident budgets
  bench_scale24      streamed FASTA ingest -> sharded IVF -> search

Each runs on the card (``--device cuda``, the default) and raises when
CUDA is absent unless given ``--device cpu``.
"""
