"""The harness loads neither JAX nor the JAX package, compared by whole
top-level names; the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import isolation

ROOT = Path(__file__).resolve().parents[2]


def loaded_after(code: str) -> set:
    """The top-level names of the modules a fresh interpreter holds after
    ``code``."""
    script = (f'import sys\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n'
              'import json\nprint(json.dumps(sorted({m.split(".")[0] '
              'for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', script], check=True,
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names():
    names = ['deeptables_torch', 'deeptables_torch.models', 'jaxtyping',
             'deeptables_tpu_extra', 'jax.numpy', 'flax', 'deeptables_tpu']
    assert isolation.forbidden_modules(names) == [
        'deeptables_tpu', 'flax', 'jax.numpy']


def test_harness_loads_no_jax():
    names = loaded_after(
        'import json\n'
        'from perfbench import run\n'
        'from perfbench.harness import spec\n'
        'for kind in ("train_fit", "serve_closed"):\n'
        '    spec.driver(kind)\n'
        'for m in json.load(open("BENCHMARK.json"))["per_layer"]:\n'
        '    spec.metric(m["name"])\n')
    assert 'deeptables_torch' in names
    assert not names & set(isolation.FORBIDDEN), names & set(
        isolation.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    """The reference and every net's module (its forward and counts; a
    net's fault imports the port only when planted)."""
    names = loaded_after('import perfbench.reference.model, '
                         'perfbench.reference.train, perfbench.counts.flops, '
                         'perfbench.counts.bounds\n'
                         'from perfbench import nets\n'
                         'for path in sorted(nets.NETS_DIR.glob("*.py")):\n'
                         '    if path.stem != "__init__":\n'
                         '        nets.load(path.stem)')
    assert 'deeptables_torch' not in names
    assert not names & set(isolation.FORBIDDEN)


# the reference's own code: its model and steps, the nets' modules (their
# faults, ``nets/faults``, are the harness's and reach into the port) and
# the counts they read
REFERENCE_DIRS = ('reference', 'nets', 'counts')
REFERENCE_PACKAGES = tuple(f'perfbench.{d}' for d in REFERENCE_DIRS)


def reaches_out(path: Path, package: str) -> list:
    """What the module at ``path``, of the package ``package``, imports
    anywhere in its source, inside functions too, that is not the
    reference's own: the port, JAX, or the harness. A call of
    ``import_module`` or ``__import__`` counts as ``<dynamic import>``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split('.')
            base = base[:len(base) - node.level + 1] if node.level else []
            module = '.'.join(base + ([node.module] if node.module else []))
            names = [module] if node.module else \
                [f'{module}.{a.name}' for a in node.names]
            if module == 'perfbench':
                names = [f'perfbench.{a.name}' for a in node.names]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                    'import_module', '__import__'):
            names = ['<dynamic import>']
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(('deeptables', 'jax', 'flax')):
            names = [node.value]
        else:
            continue
        for name in names:
            top = name.split('.')[0]
            own = name.startswith(REFERENCE_PACKAGES) and not \
                name.startswith('perfbench.nets.faults')
            if top == 'perfbench' and own or top != 'perfbench' and not (
                    top.startswith('deeptables') or top.startswith('<')
                    or top in isolation.FORBIDDEN):
                continue
            found.append(name)
    return found


def test_reference_sources_import_no_port():
    """No module of the reference, of a net or of the counts reaches the
    port, in any function: a later net's forward cannot call into the
    program it judges."""
    for d, package in zip(REFERENCE_DIRS, REFERENCE_PACKAGES):
        paths = sorted((ROOT / 'perfbench' / d).glob('*.py'))
        assert paths
        for path in paths:
            found = reaches_out(path, package)
            if path == ROOT / 'perfbench' / 'nets' / '__init__.py':
                assert found == ['<dynamic import>'], found  # nets.load
            else:
                assert found == [], (path, found)
    for path in (ROOT / 'perfbench' / 'reference').glob('*.py'):
        text = path.read_text()
        assert 'deeptables' not in text.replace('DeepTables', ''), path


@pytest.mark.parametrize('body', [
    'from deeptables_torch.ops import interactions',
    'import deeptables_torch.ops.interactions as interactions',
    'from ..harness import port',
    'from .. import harness',
    'from .faults import cin_nets',
    'from perfbench.nets.faults import cin_nets',
    'import importlib; importlib.import_module("deeptables_torch")',
    'import jax',
])
def test_a_net_forward_that_reaches_the_port_is_found(tmp_path, body):
    path = tmp_path / 'some_nets.py'
    path.write_text('def param_specs(config):\n    return []\n\n\n'
                    'def forward(params, config, parts, training, '
                    f'precision):\n    {body}\n    return None\n')
    assert reaches_out(path, 'perfbench.nets')
