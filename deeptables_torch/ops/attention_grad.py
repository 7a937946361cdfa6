# -*- coding:utf-8 -*-
"""Field attention and the fused attention block with their backward
kernels (the JAX package's custom VJPs in
``deeptables_tpu/ops/kernels/field_attention.py``).

- ``field_attention(q, k, v, num_heads, out_dtype)``: q, k, v ``(B, F, U)``
  in one type → ``(B, F, U)`` in ``out_dtype``. A
  ``torch.autograd.Function`` whose forward is K5-fwd and whose backward is
  K5-bwd (``ops/kernels/field_attention.py``). It saves q, k and v only (the
  softmax is recomputed in the backward); the cotangent is cast to the
  output's type and dq, dk, dv come out in q's type, as in ``_fa_bwd``.
- ``attention_block(x, w_aug, num_heads)``: the whole block without its
  BatchNorm, x ``(B, F, U)`` → ``(B, F, U)`` in x's type. The forward is
  K6-fwd on w_aug cast to x's type; the backward casts the cotangent to x's
  type, runs K6-bwd for dpre ``(B, F, 4U)`` in x's type, then the two
  products outside the kernel as ``_ab_bwd`` runs them in XLA: the float32
  ``dW = [x;1]ᵀ·dpre`` and ``dx = dpre·w_augᵀ`` (float32 w_aug), dx rounded
  to x's type.

Under no gradient (serving) the forward kernels run without the Functions.
"""

import torch

from .kernels.field_attention import ab_bwd, ab_fwd, fa_bwd, fa_fwd


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FieldAttentionFunction(torch.autograd.Function):
    """Field attention with the K5 forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, out_dtype):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.out_dtype = num_heads, out_dtype
        return fa_fwd(q, k, v, num_heads, out_dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fa_bwd(q, k, v, do.to(ctx.out_dtype).contiguous(),
                            ctx.num_heads)
        return dq, dk, dv, None, None


def field_attention(q, k, v, num_heads: int, out_dtype=None):
    """``softmax_g(q·kᵀ/√dh)·v`` per example and head over the fields of
    ``(B, F, H·dh)`` q, k, v of one type; the output in ``out_dtype``
    (default q's type)."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    out_dtype = out_dtype or q.dtype
    if _needs_grad(q, k, v):
        return FieldAttentionFunction.apply(q, k, v, num_heads, out_dtype)
    return fa_fwd(q, k, v, num_heads, out_dtype)


class AttentionBlockFunction(torch.autograd.Function):
    """The fused block with the K6 forward and backward. Saves x and the
    float32 w_aug, as the JAX VJP keeps them."""

    @staticmethod
    def forward(ctx, x, w_aug, num_heads):
        ctx.save_for_backward(x, w_aug)
        ctx.num_heads = num_heads
        return ab_fwd(x, w_aug.to(x.dtype).contiguous(), num_heads)

    @staticmethod
    def backward(ctx, do):
        x, w_aug = ctx.saved_tensors
        B, F, U = x.shape
        dpre = ab_bwd(x, w_aug.to(x.dtype).contiguous(),
                      do.to(x.dtype).contiguous(), ctx.num_heads)
        d = dpre.reshape(B * F, 4 * U).float()
        xf = x.reshape(B * F, U).float()
        dw = torch.cat([xf.t() @ d, d.sum(dim=0, keepdim=True)])
        dx = (d @ w_aug[:U].float().t()).reshape(B, F, U)
        return dx.to(x.dtype), dw.to(w_aug.dtype), None


def attention_block(x, w_aug, num_heads: int):
    """``relu(attention(q, k, v) + r)`` with ``[q|k|v|r] =
    relu(w_augᵀ·[x;1])``, x ``(B, F, U)``, w_aug ``(U+1, 4U)``; the output
    in x's type."""
    x = x.contiguous()
    if _needs_grad(x, w_aug):
        return AttentionBlockFunction.apply(x, w_aug, num_heads)
    return ab_fwd(x, w_aug.to(x.dtype).contiguous(), num_heads)
