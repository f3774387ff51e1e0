"""Attention dispatch (``sincformer_tpu/ops/attention.py``), the part the
flagship path needs.

  * ``impl="speech"``: kernel K1 (ops/speech_attention.py) at every T; the
    JAX package's ``T > 2048`` hand-off to a flash kernel is not needed,
    since K1's online softmax runs any T in fixed shared memory.
  * ``impl="xla"``: the plain PyTorch attention, on any device.
  * ``impl="ring"`` (context parallel) is the next slice's (ROADMAP.md
    Queue 1 item 7d); ``impl="flash"`` is JAX's library kernel (Queue 1
    item 8).
"""

from __future__ import annotations

from typing import Optional

import torch

from sincformer_tpu_torch.ops.speech_attention import (
    _speech_attention_plain, speech_attention)

_NEG = -1e9


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          impl: str = "speech") -> torch.Tensor:
    """(B, T, H, dh) attention; ``mask`` is an optional (B, T) boolean
    valid-frame mask applied on the key side."""
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, _NEG).to(torch.float32).contiguous()
    if impl == "speech":
        return speech_attention(q, k, v, bias)
    if impl == "xla":
        return _speech_attention_plain(q, k, v, bias)
    if impl == "ring":
        raise NotImplementedError(
            "impl='ring' (context-parallel attention) is not ported yet: "
            "ROADMAP.md Queue 1 item 7d (context parallel)")
    if impl == "flash":
        raise NotImplementedError(
            "impl='flash' is not ported yet: ROADMAP.md Queue 2, note on "
            "impl='flash'")
    raise ValueError(f"unknown attention impl {impl!r}")
