"""Data-parallel training over torch.distributed: one process per device.

The JAX trainers shard the batch over the `data` mesh and let XLA insert the
gradient all-reduce (proqa_tpu/train/retriever_trainer.py:8-12). Here each
process is one rank, launched by `torchrun` (or `python -m
torch.distributed.run`), whose environment names the rendezvous; a process
launched without it runs alone, with no process group. The backend is NCCL
for CUDA devices and gloo for the CPU, and one never stands in for the
other.

What a trainer does with a `DataParallel`:
* `share` gives each rank its rows of each global microbatch;
* `gather_rows` all-gathers a [micro, D] tensor with a gradient (the
  retriever's in-batch negatives span the ranks);
* `all_reduce_mean` averages the gradients, and any values riding with them,
  in ONE collective over a flat buffer;
* `sum` adds small host counts over the ranks (eval counts, batch sizes);
* `rank_seed` gives every rank past 0 a dropout stream of its own;
* only the main rank (rank 0) writes logs, metrics, checkpoints and meta.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The process group a trainer runs in; the default is one process."""
    rank: int = 0
    world: int = 1
    backend: str | None = None            # "nccl" or "gloo"; None without a group
    device: torch.device = torch.device("cpu")  # where the collectives' buffers live

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def main(self) -> bool:
        return self.rank == 0

    def share(self, batch: dict, accum: int) -> dict:
        """This rank's rows of a host batch [accum * micro, ...]: the
        rank-th W-th of every global microbatch, so each microbatch is the
        one-process step's, split over the ranks in rank order."""
        if self.world == 1:
            return batch
        out = {}
        for key, value in batch.items():
            v = np.asarray(value)
            if v.shape[0] % (accum * self.world):
                raise ValueError(f"a batch of {v.shape[0]} rows does not split into {accum} "
                                 f"microbatches over {self.world} ranks")
            per = v.shape[0] // (accum * self.world)
            out[key] = v.reshape(accum, self.world, per, *v.shape[1:])[:, self.rank].reshape(
                accum * per, *v.shape[1:])
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[m, ...] on every rank -> [world * m, ...] in rank order, with a
        gradient: its backward sums every rank's gradient of this rank's
        rows (world identical copies when every rank computes the same
        loss)."""
        if not self.grouped:
            return x
        from torch.distributed.nn.functional import all_gather

        return torch.cat(all_gather(x.contiguous()), dim=0)

    def all_reduce_mean(self, tensors: list[torch.Tensor]) -> None:
        """Average the tensors over the ranks in place, with one all-reduce
        of one flat f32 buffer."""
        if not self.grouped or not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        flat /= self.world
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def sum(self, values) -> list[float]:
        """Host numbers summed over the ranks."""
        if not self.grouped:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return t.tolist()

    def gather_objects(self, obj) -> list | None:
        """Every rank's picklable object, in rank order, on the main rank
        (None elsewhere)."""
        if not self.grouped:
            return [obj]
        out = [None] * self.world if self.main else None
        dist.gather_object(obj, out, dst=0)
        return out

    def broadcast(self, value: float) -> float:
        """The main rank's number on every rank."""
        if not self.grouped:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())


def rank_seed(seed: int, rank: int) -> int:
    """The dropout-stream seed of a rank past 0; rank 0 keeps the trainer's
    own generator, so a group of one draws what one process draws."""
    return (seed * 1_000_003 + rank) % (1 << 63)


def data_parallel(device) -> tuple[DataParallel, torch.device]:
    """The process group this process belongs to, and its device.

    An initialised group is used as it is (tests make one with a `file://`
    rendezvous); otherwise a process launched by torchrun (WORLD_SIZE in its
    environment) joins the group the launcher describes, NCCL for a CUDA
    device and gloo for the CPU; otherwise there is no group. A bare "cuda"
    device becomes this rank's card, cuda:LOCAL_RANK."""
    device = torch.device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return DataParallel(device=device), device
        dist.init_process_group(want, init_method="env://")
    backend = dist.get_backend()
    if backend != want:
        raise RuntimeError(f"a {device.type} trainer needs the {want} backend; the process "
                           f"group runs {backend}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return DataParallel(dist.get_rank(), dist.get_world_size(), backend, device), device
