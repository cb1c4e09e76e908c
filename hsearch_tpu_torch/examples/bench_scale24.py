"""2^24-point scale run: streamed FASTA ingest -> sharded IVF -> search.

    python -m hsearch_tpu_torch.examples.bench_scale24 --mode=stream
    python -m hsearch_tpu_torch.examples.bench_scale24 --mode=single
        [--device cuda]

Builds a ~16.8M-point (2^24) all-positions k-mer index from a synthetic
family FASTA:

  * ``stream`` drives the multi-process path (parallel/multihost.py) on a
    mesh of the one device: io.stream_fasta -> per-chunk all-positions
    k-mer rows -> build_ivf_index_streamed (per-shard device buffers; the
    host never stages the whole matrix) -> search_ivf at kb 256; reports
    build and search time, sample recall against the exact oracle, and
    peak host RSS.
  * ``single`` runs the single-device engine up the kb ladder 128 -> 256
    -> 512 (256 queries, center blocks of 256, retry off) until the
    sample recall reaches 0.99.  The baseline is the exact oracle on the
    same device (``vs_baseline`` = IVF q/s over oracle q/s); beside it,
    ``cpp_qps`` is the reference's single-threaded brute force
    (``native_ext.brute_search_cpp``) on 2 centers, as the JAX package's
    script reports it.
    HSEARCH_APPROX_SELECT=1 passes ``approx_select=True`` to
    ``ivf.search``: on the card the cascade's stage-1 group select is
    then approximate (``ivf._approx_topk_min``); on the CPU it stays
    exact, as the JAX package's does off the TPU.

Corpus: HSEARCH_SCALE24_NPROT proteins (default 419,431) of 64 aa, each
embedding one of 4,096 family motifs (25 aa, 1-2 substitutions) at a
random offset -> 40 windows per protein = 16,777,240 ~ 2^24 rows.
Queries are family motif centers.  The FASTA is written once to
``hsearch_torch_scale24_<nprot>.fasta`` under the temporary directory and
reused.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from .. import _device, native_ext
from ..bench import card
from ..core import alphabet, io as hio
from ..parallel import multihost
from ..search import evaluate, exact, ivf

K = 25
PLEN = 64
N_PROT = 419_431
N_FAM = 4096
RADIUS = 35.0


def fasta_path(n_prot: int) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"hsearch_torch_scale24_{n_prot}.fasta")


def ensure_fasta(path: str, n_prot: int) -> None:
    """Write the family FASTA unless ``path`` already holds it."""
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return
    rng = np.random.default_rng(24)
    fams = rng.integers(0, 20, (N_FAM, K), dtype=np.int8)
    letters = np.frombuffer(alphabet.AA20.encode(), np.uint8)
    with open(path, "w") as f:
        chunk = 65536
        for lo in range(0, n_prot, chunk):
            m = min(chunk, n_prot - lo)
            prot = rng.integers(0, 20, (m, PLEN), dtype=np.int8)
            which = rng.integers(0, N_FAM, m)
            offs = rng.integers(0, PLEN - K + 1, m)
            emb = fams[which].copy()
            # 1-2 substitutions per embedded motif
            for _ in range(2):
                sp = rng.integers(0, K, m)
                keep = rng.random(m) < 0.75
                emb[np.arange(m), sp] = np.where(
                    keep, emb[np.arange(m), sp],
                    rng.integers(0, 20, m, dtype=np.int8))
            cols = offs[:, None] + np.arange(K)[None, :]
            prot[np.arange(m)[:, None], cols] = emb
            txt = letters[prot].tobytes().decode()
            f.write("".join(f">p{lo + i}\n{txt[i * PLEN:(i + 1) * PLEN]}\n"
                            for i in range(m)))
    print(f"# wrote {path}", file=sys.stderr, flush=True)


def centers() -> np.ndarray:
    rng = np.random.default_rng(24)
    return rng.integers(0, 20, (N_FAM, K), dtype=np.int8)[:256] \
        .astype(np.int32)


def kmer_chunks(path: str, chunk_aa: int = 1 << 23):
    """All-positions K-mer rows of each streamed chunk (no window spans
    two proteins)."""
    for db in hio.stream_fasta(path, chunk_aa=chunk_aa, seed=0):
        starts = np.asarray(db.starts)
        rows = alphabet.kmer_view(np.asarray(db.seq), K)
        pos = np.arange(rows.shape[0])
        pid = np.searchsorted(starts, pos, side="right") - 1
        ok = pos + K <= starts[pid + 1]
        yield np.ascontiguousarray(rows[ok]).astype(np.int32)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def oracle_sample(cen, n_sample, db, dev):
    """The exact oracle over the whole database for a center sample (held
    on the host only for the measurement); returns it and its q/s."""
    t0 = time.perf_counter()
    g = exact.search_radius(db, cen[:n_sample], RADIUS, max_hits=2048,
                            device=dev)
    return g, n_sample / (time.perf_counter() - t0)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("stream", "single"),
                    default="single")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n_prot = int(os.environ.get("HSEARCH_SCALE24_NPROT", N_PROT))
    path = fasta_path(n_prot)
    ensure_fasta(path, n_prot)
    n_total = n_prot * (PLEN - K + 1)
    cen = centers()
    print(f"# n={n_total} mode={args.mode} on {card(dev)}",
          file=sys.stderr, flush=True)
    rows = []

    if args.mode == "stream":
        mesh = multihost.host_mesh(local_devices=[dev])
        t0 = time.perf_counter()
        idx = multihost.build_ivf_index_streamed(
            kmer_chunks(path), n_total, torch.Generator().manual_seed(0),
            mesh, K, block_size=32, max_hits=512)
        build_s = time.perf_counter() - t0
        ingest_rss = rss_gb()
        print(f"# streamed build {build_s:.1f}s rss={ingest_rss:.1f}GB",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        ci, ki, _ = multihost.search_ivf(idx, cen[:64], RADIUS,
                                         k_blocks=256)
        qps = 64 / (time.perf_counter() - t0)
        del idx
        db = np.concatenate(list(kmer_chunks(path)))
        (gci, gki, gd), oqps = oracle_sample(cen, 64, db, dev)
        rep = evaluate.recall_from_indices(gci, gki, gd, ci, ki, RADIUS)
        rows.append({
            "bench": "scale24_stream", "n": n_total,
            "build_s": round(build_s, 1),
            "ingest_peak_rss_gb": round(ingest_rss, 2),
            "qps": round(qps, 1), "oracle_qps": round(oqps, 2),
            "sample_recall": round(rep.recall, 4),
            "hits": int(len(ci)), "device": dev.type})
        print(json.dumps(rows[-1]), flush=True)
        return rows

    db = np.concatenate(list(kmer_chunks(path)))
    print(f"# db staged {db.shape} rss={rss_gb():.1f}GB", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    print(f"# build {build_s:.1f}s B={index.num_blocks}", file=sys.stderr,
          flush=True)
    (gci, gki, gd), oqps = oracle_sample(cen, 64, db, dev)
    t0 = time.perf_counter()
    native_ext.brute_search_cpp(cen[:2], db, RADIUS)
    cpp_qps = 2 / (time.perf_counter() - t0)
    approx = os.environ.get("HSEARCH_APPROX_SELECT", "0") == "1"
    kw = dict(max_hits=512, center_block=256, retry_overflow=False,
              approx_select=approx)
    for kb in (128, 256, 512):
        ivf.search(index, cen[:256], RADIUS, k_blocks=kb, stats_out={},
                   **kw)                                      # warm-up
        t0 = time.perf_counter()
        ci, ki, _ = ivf.search(index, cen[:256], RADIUS, k_blocks=kb,
                               stats_out={}, **kw)
        qps = 256 / (time.perf_counter() - t0)
        m = ci < 64
        rep = evaluate.recall_from_indices(gci, gki, gd, ci[m], ki[m],
                                           RADIUS)
        rows.append({"bench": "scale24_single", "n": n_total, "kb": kb,
                     "build_s": round(build_s, 1), "qps": round(qps, 1),
                     "oracle_qps": round(oqps, 2),
                     "cpp_qps": round(cpp_qps, 3),
                     "vs_baseline": round(qps / oqps, 1),
                     "sample_recall": round(rep.recall, 4),
                     "peak_rss_gb": round(rss_gb(), 2),
                     "device": dev.type})
        print(json.dumps(rows[-1]), flush=True)
        if rep.recall >= 0.99:
            break
    return rows


if __name__ == "__main__":
    main()
