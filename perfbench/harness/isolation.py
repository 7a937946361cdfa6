"""The modules that the measured run may not hold: JAX and the JAX package
that the port was made from, compared by whole top-level names."""

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'deeptables_tpu')


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names
                  if name.split('.')[0] in FORBIDDEN)
