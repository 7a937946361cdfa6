"""The harness loads neither JAX nor the JAX package, compared by whole
top-level names; the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

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
    names = loaded_after('import perfbench.reference.model, '
                         'perfbench.reference.train, perfbench.counts.flops, '
                         'perfbench.counts.bounds')
    assert 'deeptables_torch' not in names
    assert not names & set(isolation.FORBIDDEN)


def test_reference_sources_import_no_port():
    for path in (ROOT / 'perfbench' / 'reference').glob('*.py'):
        text = path.read_text()
        assert 'deeptables' not in text.replace('DeepTables', ''), path
