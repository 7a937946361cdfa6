# -*- coding:utf-8 -*-
"""Feature-interaction blocks (counterpart of
``deeptables_tpu/ops/interactions.py``).

Only ``FM`` is ported so far; the other blocks come with the slices that
carry their nets (see ``models/deepnets.py``).
"""

import torch
from torch import nn

from .embedding import concat_embeddings
from .kernels.fm import fm


class FM(nn.Module):
    """Factorization Machine order-2 pooling, (B, F, D) → (B, 1):
    ``0.5 · Σ_d [(Σ_f x)² − Σ_f x²]``. No parameters.

    Runs the FM kernel (``ops/kernels/fm.py``) on a CUDA input; the output
    has the input's type. An input that needs a gradient (training) goes
    through ``FMFunction``, whose backward is the FM backward kernel."""

    def forward(self, x, training: bool = False) -> torch.Tensor:
        """``x``: a stacked (B, F, D) tensor or a list of (B, 1, D)."""
        x = concat_embeddings(x)
        if x is None or x.dim() != 3:
            raise ValueError('FM expects (B, F, D) embeddings, got '
                             f'{None if x is None else tuple(x.shape)}.')
        return fm(x.contiguous())
