"""Device lists and row sharding (one axis: `data`).

Counterpart of proqa_tpu/parallel/mesh.py. The JAX package's mesh is a 1-D
`jax.sharding.Mesh` driven by one controller; here a mesh is a plain list of
`torch.device`, driven by one process. An entry may repeat a device: shards
then share that device's memory and its kernels run one after another, which
is how the CPU tests shard over `[cpu] * 8` and `chip_smoke.py` over
`[cuda:0] * 4` on one card (the JAX tests use 8 virtual CPU devices,
tests/conftest.py).
"""
from __future__ import annotations

import torch

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> list[torch.device]:
    """`devices` as torch devices, or by default every local CUDA device; the
    first `n_devices` of them when given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() defaults to the local CUDA devices and there is "
                               "none: pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices of {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def host_device_count() -> int:
    """Local CUDA devices (the JAX package counts its backend's devices)."""
    return torch.cuda.device_count()


def shard_rows(mesh: list[torch.device], x) -> list[torch.Tensor]:
    """[N, ...] -> one contiguous slab of N / len(mesh) rows per mesh entry,
    each on its device (the corpus layout). N must divide evenly."""
    n_dev = len(mesh)
    if x.shape[0] % n_dev:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n_dev} devices")
    local = x.shape[0] // n_dev
    x = torch.as_tensor(x)
    return [x[i * local:(i + 1) * local].to(dev).contiguous() for i, dev in enumerate(mesh)]


def replicate(mesh: list[torch.device], x: torch.Tensor) -> list[torch.Tensor]:
    """One copy of `x` per mesh entry, on its device."""
    return [x.to(dev) for dev in mesh]
