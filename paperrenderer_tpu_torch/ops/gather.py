"""Row gathers: PyTorch counterpart of ``paperrenderer_tpu/ops/gather.py``.

The JAX package packs several short rows into one 128-lane row before
gathering, because a TPU row gather moves a whole padded lane row per
element. That is a TPU layout trick; on the card a gather reads what it
needs, so the port keeps only the function it computes.
"""

from __future__ import annotations

import torch


def gather_rows_packed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[max(ids, 0)]`` for a 2-D [N, k] table: rows of ``ids``'s
    shape + [k], in the table's dtype; negative ids read row 0."""
    return table[torch.clamp(ids, min=0).long()]
