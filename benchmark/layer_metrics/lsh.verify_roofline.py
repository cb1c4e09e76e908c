"""``ptable_verify`` (csrc/ptable_verify.cu) at block size 1, as the LSH
search calls it, against its roofline, in %: ``verify_roofline.py``'s
reader, over the LSH engine's launch shapes (every candidate slot a
block of one row)."""

from pathlib import Path

from benchmark.registry import Registry

read = Registry(Path(__file__).resolve().parents[1]).layer_metric(
    "verify_roofline").read
