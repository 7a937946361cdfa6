"""``fm_nets``: the factorisation machine's pairwise term over the stacked
embeddings, ``0.5·Σ_d[(Σ_f e)² − Σ_f e²]``; no leaves."""


def param_specs(config):
    return []



def forward(params, config, parts, training, precision):
    emb = parts.embeddings
    s = emb.sum(dim=1)
    return 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=1, keepdim=True)


def ops_per_row(config):
    # Σ_f e, its square, Σ_f e², their difference and the sum over d
    dim = int(config['embedding_dim'])
    return 3 * len(config['vocabulary']) * dim + 3 * dim


def port_settings(config):
    return {}


def port_names(config):
    return {}
