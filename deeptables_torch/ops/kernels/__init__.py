# -*- coding:utf-8 -*-
"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds a wrapper that launches its kernel on a CUDA tensor (or
raises), runs the plain version on a CPU tensor, and counts its launches;
each call runs in a span ``deeptables.kernel.<wrapper>``
(``utils.profiling.spanned``).
Kernels are built from ``deeptables_torch/csrc`` at first launch
(``_build.py``); importing these modules builds nothing."""


def pointer_alignment(t) -> int:
    """The largest power of two, at most 256, that divides the data pointer
    of the tensor ``t``: the alignment the wrappers' design pickers take."""
    ptr = t.data_ptr()
    return min(ptr & -ptr, 256) if ptr else 256
