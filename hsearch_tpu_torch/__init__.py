"""hsearch_tpu_torch — the PyTorch/CUDA port of hsearch_tpu for NVIDIA Hopper.

Each module keeps the name and place of its counterpart in ``hsearch_tpu``
(the JAX package, which stays the reference the port is tested against):

  core/        alphabet, BLOSUM62 and its metric, the metric embedding
               and MDS, FASTA/datapoints/cluster-file IO, corpus
               preparation (k-mer sampling, unique k-mers), ORF
               translation, Pfam STOCKHOLM centers
  ops/         distances, packed hit transfer, sorted-code hash tables,
               hand-written CUDA kernels (csrc/*.cu, built with nvcc at
               first use)
  lsh/         p-stable LSH and its operating-point sweep
  search/      exact oracle, block-pruned IVF engine (with optional Lloyd
               refinement), the segmented engine for databases larger than
               the card's memory, LSH motif search, recall evaluation
  align/       the protein aligner: murphy10 seed index, batched
               seed-extend (window-dense and chunked), the banded gapped
               scorer, Karlin-Altschul statistics, the search pipeline
               with m8/aln output, and its host passes in numpy
  cluster/     greedy (hclust2/3) and centroid (hclust) k-mer clustering,
               the center-distance merge, post-processing, union-find,
               whole-protein clustering (pcluster: KLSH pre-groups)
  parallel/    (data, db) device meshes, db-sharded LSH and IVF search
               and exact top-k, the multi-process runtime on
               torch.distributed, data-parallel embedding training
  metric       BLOSUM-metric validation: k-best peptides, agreement
  utils/       index checkpointing (the ``ivf``, ``motif``, ``segivf`` and
               ``seed`` .npz kinds), index statistics, phase timing and
               tracing
  cli          ``python -m hsearch_tpu_torch <tool>``: protein2datapoints,
               motif-search, motif-search-exact, index-build, serve,
               lsh-sweep, hclust2/3, hclust, pcluster, postprocess,
               evaluate2, evaluate-motifs, shuffle-kmers,
               kmer2coordinates, gen-kmers, orf, stockholm, fit-embedding

The port imports torch and numpy only — never jax, never hsearch_tpu.
Every entry point takes ``device`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller asked for ``"cpu"``.
"""

__version__ = "0.1.0"
