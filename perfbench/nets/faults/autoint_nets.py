"""``autoint_nets``'s own fault, planted in the port under the timed path."""

# the interacting layer whose attention ``head_swap`` breaks
HEAD_SWAP_BLOCK = 1


def head_swap(model):
    """``head_swap``: the field attention (K5) of interacting layer
    ``HEAD_SWAP_BLOCK`` returns its heads' columns in reverse order (two
    heads: swapped), as a kernel that wrote each head's context to the
    other's place would; its gradient is left as it was. Set over the
    port's attention (a module global of ``ops/interactions.py``),
    replacing one planted before; the layer is told by a forward pre-hook
    and a forward hook on its block."""
    from deeptables_torch.ops import interactions
    original = getattr(interactions.field_attention, 'planted_over',
                       interactions.field_attention)
    block = getattr(model.build(), f'autoint_attention_{HEAD_SWAP_BLOCK}')
    inside = []

    def leave(module, args, out):
        inside.pop()  # returns None: the block's output stands

    block.register_forward_pre_hook(lambda module, args: inside.append(1))
    block.register_forward_hook(leave)

    def attention(q, k, v, num_heads, out_dtype=None):
        out = original(q, k, v, num_heads, out_dtype)
        if not inside:
            return out
        batch, n_fields, units = out.shape
        swapped = out.reshape(batch, n_fields, num_heads,
                              units // num_heads).flip(2).reshape(out.shape)
        return out + (swapped - out).detach()

    attention.planted_over = original
    interactions.field_attention = attention


faults = {'head_swap': head_swap}
