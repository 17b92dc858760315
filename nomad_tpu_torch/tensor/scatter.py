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
    if not used.is_cuda:
        if used.device.type == "cpu":
            return scatter_add_ref(used, idx, delta)
        raise ValueError(f"scatter_add: unsupported device {used.device}")
    n, d = used.shape
    b = idx.shape[0]
    card = used.get_device()
    if not (used.dtype is torch.float32 and used.is_contiguous()
            and idx.get_device() == card and idx.dtype is torch.int32
            and idx.dim() == 1 and idx.is_contiguous()
            and delta.get_device() == card and delta.dtype is torch.float32
            and delta.shape == (b, d) and delta.is_contiguous()):
        raise ValueError(
            f"scatter_add: used must be a contiguous float32 (N, D) tensor, "
            f"idx int32 (B,) and delta float32 (B, D) on its card, got "
            f"{used.dtype} {tuple(used.shape)} on {used.device}, "
            f"{idx.dtype} {tuple(idx.shape)} on {idx.device}, "
            f"{delta.dtype} {tuple(delta.shape)} on {delta.device}")
    if b:  # no rows, no launch
        _ext.launch("scatter_add", used.device, _ext.entry("nt_scatter_add"),
                    used.data_ptr(), idx.data_ptr(), delta.data_ptr(), b, d,
                    n)
    return used
