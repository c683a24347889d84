"""The exact integer collectives of the sharded paths.

Three collectives over one mesh axis (a `torch.distributed` group): a sum
all-reduce, a sum reduce-scatter along a named dimension and an
all-gather.  The sums take int64 tensors: residues are below 2**30, so a
sum over up to 2**33 ranks is exact, and the canonical reduction is the
caller's.  The all-gather only moves data and takes int32 or int64.

The transport is the group's backend, named by whoever initialised the
process group, and nothing here changes it.  `gloo` is the default and the
only one when several ranks share one card: NCCL refuses two ranks on one
device.  Under gloo every collective stages through a host buffer: the
tensor is copied to the CPU, the collective runs on the CPU copy, and the
result is copied back to the caller's device.  That is the one code path
for CPU and CUDA tensors alike, so nothing depends on which collectives a
torch build's gloo takes for CUDA tensors.  `nccl` (one rank per card)
hands the device tensors to the collective as they are.

Each call adds the bytes of the tensor it hands to the collective to
`utils.timing.COLLECTIVE_BYTES`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.timing import COLLECTIVE_BYTES

TRANSPORTS = ("gloo", "nccl")


class Comm:
    """The collectives over one process group (a mesh axis)."""

    def __init__(self, group, transport: str):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} is not one of "
                             f"{TRANSPORTS}")
        self.group = group
        self.transport = transport
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the collective works on: a contiguous host copy under
        gloo (never the caller's own storage), the tensor itself under
        nccl."""
        if self.transport == "gloo":
            return x.to("cpu", copy=True).contiguous()
        return x.contiguous()

    def _count(self, kind: str, x: torch.Tensor) -> None:
        COLLECTIVE_BYTES[kind] += x.numel() * x.element_size()

    @staticmethod
    def _sum_dtype(x: torch.Tensor) -> None:
        if x.dtype != torch.int64:
            raise TypeError(f"sum collectives take int64, got {x.dtype}")

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of x over the group, on every rank."""
        self._sum_dtype(x)
        if self.size == 1:
            return x
        h = self._stage(x)
        self._count("all_reduce", h)
        dist.all_reduce(h, group=self.group)
        return h.to(x.device)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of x over the group, cut along `dim` into one block per
        rank in rank order; returns this rank's block."""
        self._sum_dtype(x)
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {self.size} ranks")
        h = self._stage(x.movedim(dim, 0))
        out = torch.empty((h.shape[0] // self.size,) + h.shape[1:],
                          dtype=h.dtype, device=h.device)
        self._count("reduce_scatter", h)
        dist.reduce_scatter_tensor(out, h, group=self.group)
        return out.to(x.device).movedim(0, dim)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x concatenated along `dim` in rank order."""
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"all_gather takes int32 or int64, got {x.dtype}")
        if self.size == 1:
            return x
        h = self._stage(x.movedim(dim, 0))
        out = torch.empty((h.shape[0] * self.size,) + h.shape[1:],
                          dtype=h.dtype, device=h.device)
        self._count("all_gather", h)
        dist.all_gather_into_tensor(out, h, group=self.group)
        return out.to(x.device).movedim(0, dim)
