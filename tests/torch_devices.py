"""A stand-in for a device the port has no kernel for, shared by the kernel
tests: the CPU build of torch holds tensors on the CPU and the meta device
only, and a meta tensor is the dry run's shape-only input, which the kernel
entries send to their plain versions.  ``elsewhere(t)`` is ``t`` reporting
another device (``xpu``), so an entry's device check sees a tensor that is
neither on the CPU, on the meta device nor on a card."""
import torch


class Elsewhere(torch.Tensor):
    @property
    def device(self):
        return torch.device("xpu")


def elsewhere(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(Elsewhere)
