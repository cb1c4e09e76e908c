"""Data-parallel training of the metric embedding (counterpart of
hsearch_tpu/parallel/train.py).

The reference generated its 20x8 coordinate table once, offline, in MATLAB
(IGC/distance2coordinate/BLOSUM.m:25-33 ``mdscale``).  Here the embedding
is trained: stress (the error between embedded distances and the
BLOSUM62 metric, core/blosum.py) is minimized by Adam over batches of
random k-mer pairs, drawn with numpy so that one seed gives both packages
the same batches.

With a mesh the step is data-parallel: the batch is split evenly over the
mesh's devices, each computes the gradient of its slice's mean loss, the
gradients are averaged (and, when the mesh spans processes, all-reduced
and divided by the world size), and the replicated coordinates take one
optimizer step: the gradient of the whole batch's mean loss, as on one
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import _device
from ..core import blosum
from . import mesh as mesh_lib


def stress_loss(coords: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                target_d2: torch.Tensor) -> torch.Tensor:
    """Kruskal stress: squared error between embedded and target distances.

    coords (20, d); xa, xb (B, L) int k-mer pairs; target_d2 (B,) f32 =
    sum_l metric_d2(xa_l, xb_l).  Matches mdscale's metric-stress
    objective (BLOSUM.m:25-33); the 1e-12 keeps the square root's gradient
    finite at d = 0.
    """
    ea = coords[xa.long()]                          # (B, L, d)
    eb = coords[xb.long()]
    d2 = torch.sum((ea - eb) ** 2, dim=(1, 2))      # (B,)
    d = torch.sqrt(d2 + 1e-12)
    return torch.mean((d - torch.sqrt(target_d2)) ** 2)


def make_train_step(optimizer: torch.optim.Optimizer, mesh=None):
    """step(xa, xb, target_d2) -> loss: one optimizer step on the
    optimizer's single parameter, the (20, d) coordinates.

    With a mesh (parallel/mesh.py) the batch is split evenly over the
    mesh's devices and the per-device gradients are averaged, across
    processes too when the mesh spans them; the batch size must be a
    multiple of the device count.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1:
        raise ValueError("the optimizer must hold exactly the coordinates")
    coords = params[0]

    def step(xa, xb, target_d2):
        optimizer.zero_grad()
        if mesh is None:
            loss = stress_loss(coords, xa, xb, target_d2)
            loss.backward()
            optimizer.step()
            return loss.detach()
        devs = mesh.flat()
        n = len(devs)
        if xa.shape[0] % n:
            raise ValueError(f"batch {xa.shape[0]} does not split evenly "
                             f"over the mesh's {n} devices")
        per = xa.shape[0] // n
        grad = torch.zeros_like(coords)
        loss = torch.zeros((), dtype=coords.dtype, device=coords.device)
        for i, dev in enumerate(devs):
            sl = slice(i * per, (i + 1) * per)
            local = coords.detach().to(dev).requires_grad_()
            part = stress_loss(local, xa[sl].to(dev), xb[sl].to(dev),
                               target_d2[sl].to(dev))
            (g,) = torch.autograd.grad(part, local)
            grad += g.to(coords.device)
            loss += part.detach().to(coords.device)
        if mesh.spans_processes:
            both = torch.cat([grad.reshape(-1), loss.reshape(1)])
            red = both.to(mesh_lib.collective_device())
            dist.all_reduce(red)
            both = red.to(coords.device) / dist.get_world_size()
            grad, loss = both[:-1].reshape(coords.shape), both[-1]
        coords.grad = grad / n
        optimizer.step()
        return loss / n

    return step


def sample_pair_batch(rng: np.random.Generator, batch: int, kmer_len: int):
    """Random k-mer pairs + their BLOSUM-metric squared distances."""
    xa = rng.integers(0, 20, (batch, kmer_len), dtype=np.int32)
    xb = rng.integers(0, 20, (batch, kmer_len), dtype=np.int32)
    d2 = blosum.BLOSUM_DISTANCE[xa, xb].astype(np.float32) ** 2
    return xa, xb, d2.sum(axis=1)


def fit_embedding(dim: int = 8, steps: int = 2000, batch: int = 4096,
                  kmer_len: int = 1, lr: float = 3e-2, seed: int = 0,
                  mesh=None, device: str | torch.device = "cuda"
                  ) -> np.ndarray:
    """Train a (20, dim) embedding of the BLOSUM62 metric from scratch:
    the numpy ``rng`` of ``seed`` draws the initial coordinates and every
    batch, as in the JAX package; Adam(lr) takes the steps."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    coords = torch.tensor(rng.normal(0, 1.0, (20, dim)), dtype=torch.float32,
                          device=dev, requires_grad=True)
    step = make_train_step(torch.optim.Adam([coords], lr=lr), mesh)
    for _ in range(steps):
        xa, xb, d2 = sample_pair_batch(rng, batch, kmer_len)
        step(torch.as_tensor(xa, device=dev), torch.as_tensor(xb, device=dev),
             torch.as_tensor(d2, device=dev))
    return coords.detach().cpu().numpy()
