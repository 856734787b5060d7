"""Correctly rounded elementwise square root, the same bits in every process.

On the CPU, `torch.sqrt` of a float tensor runs MKL's VML (`vsSqrt`) in
blocks of 2,048 elements, one block per OpenMP worker thread.  On its first
call in a process, one worker's block has come back off by 4,400-5,100 ulp,
the size of a 12-bit square-root estimate, so stage 1 could give another
feature set from one process to the next.  numpy's float32 and float64
loops are the IEEE square-root instruction on the calling thread: the
correctly rounded result, which equals the float64 square root rounded once
to float32 (53 >= 2 * 24 + 2, so that double rounding is exact) and
XLA:CPU's.  A single `/` needs nothing of the kind: PyTorch divides float32
with the IEEE instruction on every path.

On CUDA, `torch.sqrt` is already the correctly rounded `sqrtf`, so the card
keeps it: no copy to the host, no float64.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Elementwise square root of a float tensor, correctly rounded on any
    device and thread count.  No autograd on the CPU route."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    a = x.detach().numpy()
    return torch.from_numpy(np.sqrt(a, out=np.empty(a.shape, a.dtype)))
