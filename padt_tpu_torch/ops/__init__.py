"""The port's operations: plain PyTorch forms and the CUDA kernels' wrappers
(`cuda_*`). Each wrapper module counts its launches in `launch_counts`
(with splits by shape where it keeps them, all listed in its `TALLIES`)
and zeroes them in `reset_launch_counts`."""


def kernel_modules() -> tuple:
    """The CUDA kernel wrappers' modules."""
    from . import cuda_attention, cuda_flash_bwd, cuda_kv, cuda_matmul, cuda_mlp, cuda_moe, cuda_quant

    return (cuda_attention, cuda_flash_bwd, cuda_kv, cuda_matmul, cuda_quant, cuda_moe, cuda_mlp)


def launch_tallies() -> tuple:
    """Every dict of launch counts that a kernel wrapper adds to."""
    return tuple(t for m in kernel_modules() for t in m.TALLIES)
