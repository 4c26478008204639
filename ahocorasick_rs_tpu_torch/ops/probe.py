"""Layout probes P1 and P2 on the fire kernel's ``[R, 128]`` layout.

The JAX package measured, with two small Pallas kernels, what a
transposed fire layout would cost (``tools/probe_transpose_kernel.py``
there): a max over groups of 16 rows (P1, the COARSE reduction of such a
layout) and each row ANDed with the next row of its 1024-row block (P2,
its fingerprint shift).  Here they are CUDA kernels (``csrc/probe.cu``)
with a plain PyTorch version beside each wrapper, which the wrapper takes
for CPU tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _kernels

#: rows per block of the probes' layout (the reference's ``R``)
BLOCK_ROWS = _kernels.PROBE_BLOCK_ROWS
#: rows per group of the P1 reduction
GROUP_ROWS = 16


def _reduce16_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P1."""
    return x.view(-1, GROUP_ROWS, 128).amax(1)


def _rollrows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of P2."""
    b = x.view(-1, BLOCK_ROWS, 128)
    return (b & torch.roll(b, -1, 1)).view_as(x)


def reduce16(x: torch.Tensor) -> torch.Tensor:
    """P1: uint8 ``[R/16, 128]``, ``out[g, l] = max_{r<16} x[16g+r, l]``
    of a uint8 ``[R, 128]`` array, R a multiple of 1024."""
    if x.device.type == "cpu":
        return _reduce16_plain(x)
    return _kernels.probe_reduce(x)


def rollrows(x: torch.Tensor) -> torch.Tensor:
    """P2: ``out[b*1024+r, l] = x[b*1024+r, l] & x[b*1024+(r+1)%1024, l]``
    of a uint8 ``[R, 128]`` array, R a multiple of 1024."""
    if x.device.type == "cpu":
        return _rollrows_plain(x)
    return _kernels.probe_rollrows(x)
