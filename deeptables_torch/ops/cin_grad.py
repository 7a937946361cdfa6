# -*- coding:utf-8 -*-
"""The CIN contraction with its backward kernel (counterpart of
``deeptables_tpu/ops/cin_grad.py``).

``cin_contract(x0, h, w)`` computes ``z_bld = Σ_fg x0_bfd h_bgd w_lfg`` on
(B, F, D), (B, G, D), (L, F, G) → (B, L, D) float32, and
``cin_contract_bm(x0T, hT, w)`` the same on the JAX package's batch-minor
(F, D·B), (G, D·B) operands → (L, D·B). Each is a ``torch.autograd.Function``
whose forward is the K4 kernel and whose backward is K3
(``ops/kernels/cin.py``), with the JAX custom VJPs' rounding points:

- the operands are cast to the activation type ``cd = x0.dtype`` (h may
  arrive in float32 from the previous layer, w is a float32 parameter);
  z comes out in float32;
- dz is cast to ``cd`` before the backward kernel;
- dx0 and dh come out of the kernel in ``cd`` and are then cast to x0's and
  h's types (so a float32 h gets a gradient rounded to bfloat16 under the
  bfloat16 policy, as in JAX); dW is float32.

Under no gradient (serving) the forward kernel runs without the Function.

The knobs of the JAX package are accepted: ``formulation`` /
``DT_CIN_BWD`` names one of ``FORMULATIONS`` and an unknown name raises.
On a TPU the names chose among XLA layouts of the same gradient; the port
has one backward, the kernel, for every name (logged once). The TPU tile
option ``DT_CIN_BWD_CHUNK_F`` is read and changes nothing; a value that is
neither an integer nor ``auto`` is logged and read as 0. No name and no
setting routes a CUDA tensor to the plain version.
"""

import logging
import os

import torch

from ..utils import dt_logging
from .kernels.cin import cin_bwd, cin_fwd

logger = dt_logging.get_logger(__name__)

FORMULATIONS = ('auto', 'assoc', 'bm', 'pallas')

_logged = set()


def _log_once(key, level, message):
    if key not in _logged:
        _logged.add(key)
        logger.log(level, message)


def default_formulation() -> str:
    """``DT_CIN_BWD``, default ``'pallas'`` (the JAX package's default)."""
    return os.environ.get('DT_CIN_BWD', 'pallas')


def chunk_f_setting():
    """``DT_CIN_BWD_CHUNK_F`` as the JAX package reads it (an integer or
    ``'auto'``, default 0). It chose a TPU tile and changes nothing here; a
    value that is neither is logged and read as 0, where JAX raises."""
    env = os.environ.get('DT_CIN_BWD_CHUNK_F', '0')
    if env == 'auto':
        return env
    try:
        return int(env)
    except ValueError:
        _log_once(('chunk_f', env), logging.WARNING,
                  f'DT_CIN_BWD_CHUNK_F={env!r} is neither an integer nor '
                  f"'auto'; reading it as 0 (it selects a TPU tile and "
                  f'changes nothing in deeptables_torch).')
        return 0


def _check_formulation(formulation):
    if formulation is None:
        formulation = default_formulation()
    if formulation not in FORMULATIONS:
        raise ValueError(f'unknown CIN backward formulation {formulation!r}; '
                         f'expected one of {FORMULATIONS}')
    if formulation != 'pallas':
        _log_once('formulation', logging.INFO,
                  f'CIN backward formulation {formulation!r}: '
                  f'deeptables_torch has one backward (the CIN kernel) for '
                  f'every formulation.')


def _operands(x0, h, w):
    cd = x0.dtype
    return (x0.contiguous(), h.to(cd).contiguous(), w.to(cd).contiguous())


class CINFunction(torch.autograd.Function):
    """The contraction with the K4 forward and the K3 backward. Saves the
    operands in ``cd``, as the JAX VJP keeps them."""

    @staticmethod
    def forward(ctx, x0, h, w):
        x0c, hc, wc = _operands(x0, h, w)
        ctx.save_for_backward(x0c, hc, wc)
        ctx.types = (x0.dtype, h.dtype, w.dtype)
        return cin_fwd(x0c, hc, wc)

    @staticmethod
    def backward(ctx, dz):
        x0c, hc, wc = ctx.saved_tensors
        x0_type, h_type, w_type = ctx.types
        chunk_f_setting()
        dx0, dh, dw = cin_bwd(x0c, hc, wc, dz.to(x0c.dtype).contiguous())
        return dx0.to(x0_type), dh.to(h_type), dw.to(w_type)


def _contract(x0, h, w):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x0, h, w)):
        return CINFunction.apply(x0, h, w)
    return cin_fwd(*_operands(x0, h, w))


def cin_contract(x0, h, w, formulation=None):
    """``z_bld = Σ_fg x0_bfd h_bgd w_lfg`` → (B, L, D) float32.

    ``formulation`` in ``FORMULATIONS``; None reads ``DT_CIN_BWD``. Every
    formulation runs the same kernels."""
    _check_formulation(formulation)
    return _contract(x0, h, w)


def cin_contract_bm(x0T, hT, w):
    """Batch-minor contraction: ``z_l,(d b) = Σ_fg x0_f,(d b) h_g,(d b)
    w_lfg`` on x0T (F, D·B), hT (G, D·B), w (L, F, G) → zT (L, D·B)
    float32: the kernels read a ``(1, F, D·B)`` tensor as B = 1 example of
    D·B columns."""
    return _contract(x0T[None], hT[None], w)[0]
