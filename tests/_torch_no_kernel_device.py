"""A tensor on a device the port has no kernel for: the kernel ops take
the plain version on a CPU tensor, return their plain version's shape on
a meta tensor (the dry run), launch on a CUDA one, and must raise on any
other device. XPU stands for that other device here: a wrapper tensor
with its shape and dtype and no storage, on which every tensor op
raises."""
import torch


class NoKernelTensor(torch.Tensor):
    @staticmethod
    def __new__(cls, shape, dtype=torch.bfloat16):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor with no storage")
