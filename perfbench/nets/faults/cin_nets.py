"""``cin_nets``'s own fault, planted in the port under the timed path."""

import torch

# the maps that ``cin_tile`` zeroes
CIN_TILE = 8


def cin_tile(model):
    """``cin_tile``: the CIN's second contraction (K4 of layer 1) returns
    its last ``CIN_TILE`` maps as zeros, as a kernel that skipped them
    would; its gradient is left as it was. Set over the port's contraction
    (a module global of ``ops/interactions.py``), replacing one planted
    before."""
    from deeptables_torch.ops import interactions
    original = getattr(interactions.cin_contract, 'planted_over',
                       interactions.cin_contract)
    target = model.build().cin_layer.f_1

    def contract(x0, h, w, *args):
        z = original(x0, h, w, *args)
        if w is not target:
            return z
        lost = torch.zeros_like(z)
        lost[:, -CIN_TILE:] = z[:, -CIN_TILE:].detach()
        return z - lost

    contract.planted_over = original
    interactions.cin_contract = contract


faults = {'cin_tile': cin_tile}
