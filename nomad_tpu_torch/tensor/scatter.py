"""B4: the usage scatter-add ``used[idx] += delta``
(reference ``nomad_tpu/tensor/incremental.py:98-117``, ``state_scatter`` /
``state_fold``). Duplicate rows accumulate; ``(0, 0)`` padding slots are
an exact no-op. Unlike the reference's donating jit, the carry is updated
in place. Indices must lie in ``[0, N)``.
"""

from __future__ import annotations

import torch

from .. import _ext


def scatter_add_ref(used: torch.Tensor, idx: torch.Tensor,
                    delta: torch.Tensor) -> torch.Tensor:
    """Plain version: one ``index_add_``. Updates ``used`` in place and
    returns it."""
    _ext.COUNTS.plain("scatter_add", used)
    return used.index_add_(0, idx.to(torch.int64), delta)


def scatter_add(used: torch.Tensor, idx: torch.Tensor,
                delta: torch.Tensor) -> torch.Tensor:
    """``used[idx] += delta`` in place: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if used.device.type == "cpu":
        return scatter_add_ref(used, idx, delta)
    if not used.is_cuda:
        raise ValueError(f"scatter_add: unsupported device {used.device}")
    n, d = used.shape
    b = idx.shape[0]
    for name, t, dtype, shape in (("used", used, torch.float32, (n, d)),
                                  ("idx", idx, torch.int32, (b,)),
                                  ("delta", delta, torch.float32, (b, d))):
        if (t.device != used.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"scatter_add: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {used.device}")
    fn = _ext.entry("nt_scatter_add")
    _ext.launch(
        "scatter_add", used.device, fn,
        used.data_ptr(), idx.data_ptr(), delta.data_ptr(), b, d, n)
    return used
