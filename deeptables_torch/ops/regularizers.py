# -*- coding:utf-8 -*-
"""Weight and activity regularizers (counterpart of
``deeptables_tpu/ops/regularizers.py``, Keras-compatible identifiers).

A regularizer is a function ``tensor -> scalar``; ``DeepModel``'s train
step adds the embedding weight penalty and the embedding activity penalty
to the loss.

Accepted identifiers:
- ``None`` → no regularizer
- ``'l1'`` / ``'l2'`` / ``'l1_l2'`` (Keras default coefficient 0.01)
- ``('l1', c)`` / ``('l2', c)`` / ``('l1_l2', c1, c2)``
- ``{'l1': c1, 'l2': c2}`` (either key optional)
- any callable ``tensor -> scalar``
"""

import torch

_DEFAULT_COEF = 0.01  # keras.regularizers default


def _l1_l2(l1=0.0, l2=0.0):
    l1, l2 = float(l1), float(l2)

    def reg(w):
        w = w.to(torch.float32)
        pen = 0.0
        if l1:
            pen += l1 * w.abs().sum()
        if l2:
            pen += l2 * torch.square(w).sum()
        return pen

    return reg


def get_regularizer(identifier):
    """Resolve a regularizer identifier to ``fn(tensor) -> scalar`` or
    None."""
    if identifier is None:
        return None
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        name = identifier.lower()
        if name == 'l1':
            return _l1_l2(l1=_DEFAULT_COEF)
        if name == 'l2':
            return _l1_l2(l2=_DEFAULT_COEF)
        if name in ('l1_l2', 'l1l2'):
            return _l1_l2(l1=_DEFAULT_COEF, l2=_DEFAULT_COEF)
        raise ValueError(f'Unknown regularizer: {identifier!r}')
    if isinstance(identifier, dict):
        extra = set(identifier) - {'l1', 'l2'}
        if extra:
            raise ValueError(f'Unknown regularizer keys: {sorted(extra)}')
        return _l1_l2(identifier.get('l1', 0.0), identifier.get('l2', 0.0))
    if isinstance(identifier, (tuple, list)):
        name = str(identifier[0]).lower()
        if name == 'l1' and len(identifier) == 2:
            return _l1_l2(l1=identifier[1])
        if name == 'l2' and len(identifier) == 2:
            return _l1_l2(l2=identifier[1])
        if name in ('l1_l2', 'l1l2') and len(identifier) == 3:
            return _l1_l2(l1=identifier[1], l2=identifier[2])
        raise ValueError(f'Cannot interpret regularizer: {identifier!r}')
    raise ValueError(f'Cannot interpret regularizer: {identifier!r}')
