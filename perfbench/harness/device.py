"""The card: synchronising, memory, and the port's launch counters."""

import gc

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def synchronize(device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


def reset_peak(device):
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if is_cuda(device) else 0


def free(device):
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def launch_counters() -> dict:
    """The port's kernel wrappers' ``launches`` counters."""
    from deeptables_torch.ops.kernels import cin, emb_grad, fm
    return {'cin_fwd': cin.cin_fwd.launches, 'cin_bwd': cin.cin_bwd.launches,
            'fm': fm.fm.launches, 'fm_backward': fm.fm_backward.launches,
            'emb_grad': emb_grad.emb_grad.launches}


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
