"""The model's entry point to flash attention (port of the reference
``kernels/flash_attention/ops.py``).

The reference sends ``fused_attention`` to the Pallas kernel on a TPU and
to ``chunked_attention`` elsewhere; both compute one function.  Here it
goes to ``flash_attention``, which launches the CUDA kernel for a CUDA
tensor and runs the kernel's plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd], what
    ``chunked_attention`` computes for any lengths."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)
