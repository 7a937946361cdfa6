"""The nets of a configuration, one module a net name: ``nets/<net>.py``.

A configuration's ``nets`` names DeepTables nets (``linear``, ``cin_nets``,
…); the harness finds each one's module here by that name, and knows no
net otherwise. A module gives:

- ``param_specs(config)``: its trained leaves, ``[(name, shape, init)]``
  with ``init`` ``('uniform', lo, hi)``, dense weights ``(out, in)``;
- ``forward(params, config, parts, training, precision)``: its logit
  ``(B, 1)`` from ``parts`` (``reference.model.Parts``), its products
  through ``reference.model.matmul`` at ``precision``;
- ``ops_per_row(config)``: the operations of one example's forward
  (``counts/flops.py`` says what is counted);
- ``port_settings(config)``: the ``ModelConfig`` keywords it needs;
- ``port_names(config)``: ``{leaf or statistic: the port's state_dict
  key}``;

and may give ``statistics(config, draw)``, ``{name: tensor}``, the running
statistics of the BatchNorms it owns (read at inference), from
``draw(shape, lo, hi)``, a float32 ``U(lo, hi)`` tensor on the device;
``kernel_calls(config, rows, phase)``, the shapes of its hand-written
kernels' calls in a training step (``phase`` ``'train'``) or an inference
forward (``'infer'``) of ``rows`` examples, ``{kernel: [shape, ...]}``;
and ``bounds``, ``{kernel: counts.bounds.KernelBound}`` for those kernels.
A net module is the reference's and imports nothing of the port.

A net's own faults, planted in the port under the timed path, are
``nets/faults/<net>.py``'s ``faults``, ``{name: plant(model)}``
(``harness/faults.py``).

A net with no module is refused with the path looked for."""

import importlib
import re
from pathlib import Path

import torch

NETS_DIR = Path(__file__).resolve().parent
NAME = re.compile(r'[A-Za-z][A-Za-z0-9_]*\Z')

# the activations a configuration may name, by DeepTables' names
ACTIVATIONS = {'relu': torch.relu, 'linear': lambda x: x}


def path(name: str, nets_dir: Path = NETS_DIR) -> Path:
    """The module file of net ``name``; FileNotFoundError, with the path,
    where there is none."""
    if not NAME.match(name):
        raise ValueError(f'{name!r} is no net name')
    file = nets_dir / f'{name}.py'
    if not file.is_file():
        raise FileNotFoundError(f'net {name!r} has no module: {file} is '
                                f'missing')
    return file


def load(name: str):
    path(name)
    return importlib.import_module(f'{__name__}.{name}')


def of(config) -> list:
    """``[(name, module)]`` of the configuration's nets, in its order."""
    return [(name, load(name)) for name in config['nets']]


def bounds(config) -> dict:
    """``{kernel: KernelBound}`` of every net of the configuration."""
    out = {}
    for _, net in of(config):
        out.update(getattr(net, 'bounds', {}))
    return out


def kernel_calls(config, work) -> dict:
    """``{kernel: [shape, ...]}`` of the nets' kernel calls over ``work``,
    ``[(rows, phase), ...]`` in order."""
    out = {}
    for rows, phase in work:
        for _, net in of(config):
            if hasattr(net, 'kernel_calls'):
                for kernel, shapes in net.kernel_calls(config, rows,
                                                       phase).items():
                    out.setdefault(kernel, []).extend(shapes)
    return out
