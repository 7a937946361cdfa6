"""The readings that the limits of ``perfbench/limits`` are set from.

    python3 perfbench/proof.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2] \
        [--out readings.jsonl]

On the card, at the cell's own sizes, in one process: for each seed of
``--seeds`` the program's compared numbers against the reference that
judges a run (float64, the drivers' ``PRECISION``); for each of
``--control-seeds`` also the control's (the reference computed with its
matrix products in TF32, the precision below the configuration's float32
with TF32 off, in the program's place) and, as a witness of float32's own
rounding, the float32 reference's, against the same; for each of
``--fault-seeds`` the program's with each fault of ``harness/faults.py``
that the cell's driver can have, and each fault of the configuration's
nets (``perfbench/nets/faults``), planted under the timed path. Each reading
gives the device memory peak of the judging reference's run
(``reference_peak_bytes``). A training cell's readings
need no window (the first steps are read in set-up); a serving cell's take
a window of ``--seconds`` at the cell's own load. One JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAULTS = {'train_fit': ('half_batch', 'unchanged_state'),
          'serve_closed': ('altered_answer', 'half_rows')}


def _seeds(text):
    return [int(s) for s in text.split(',') if s] if text else []


def _norms(readings):
    """The losses and the leaves' norms, as floats, so that a compared
    number can be worked out again from the reading."""
    return {'losses': [float(x) for x in readings['losses']],
            **{key: {k: float(v) for k, v in readings[key].items()}
               for key in ('grad_norms', 'change_norms')}}


def train_readings(driver, cell, seed, device, fault=None, control=False):
    from perfbench.harness import device as dev
    model, probe, steps, _, _ = driver.first_steps(cell, seed, device, fault)
    program, batches = steps.readings(), steps.batches
    probe.remove()
    del model, probe, steps
    dev.free(device)
    dev.reset_peak(device)
    ref = driver.reference(cell, seed, device, batches)
    numbers, worst = driver.numbers(program, ref)
    out = {'program': numbers, 'worst': worst,
           'reference_peak_bytes': dev.memory_peak(device),
           'norms': {'program': _norms(program), 'reference': _norms(ref)}}
    if control:
        tf32 = driver.reference(cell, seed, device, batches, 'tf32')
        out['control'] = driver.numbers(tf32, ref)[0]
        fp32 = driver.reference(cell, seed, device, batches, 'fp32')
        out['float32_reference'] = driver.numbers(fp32, ref)[0]
        out['norms'].update(control=_norms(tf32),
                            float32_reference=_norms(fp32))
    return out


def serve_readings(driver, cell, seed, device, seconds, fault=None,
                   control=False):
    from perfbench.harness import device as dev
    mix, model, probe, predictor = driver.setup(cell, seed, device, fault)
    answers, _, _, _, _ = driver.serve(mix, predictor, probe, seconds,
                                       device)
    probe.remove()
    del predictor, model, probe
    dev.free(device)
    picked = driver.sample(answers, seed)
    requests = [answers[i][:2] for i in picked]
    dev.reset_peak(device)
    ref = driver.reference(cell, seed, device, mix, requests)
    out = {'program': {'proba_gap': driver.proba_gap(
        [answers[i][2] for i in picked], ref)},
        'requests': len(answers), 'compared': len(picked),
        'longest': max(r[1] for r in requests),
        'reference_peak_bytes': dev.memory_peak(device)}
    if control:
        tf32 = driver.reference(cell, seed, device, mix, requests, 'tf32')
        out['control'] = {'proba_gap': driver.proba_gap(tf32, ref)}
        fp32 = driver.reference(cell, seed, device, mix, requests, 'fp32')
        out['float32_reference'] = {'proba_gap': driver.proba_gap(fp32,
                                                                  ref)}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--fault-seeds', default='')
    parser.add_argument('--seconds', type=float, default=2.0)
    parser.add_argument('--out', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    import torch
    from perfbench.harness import faults as faults_lib, spec as spec_lib
    cell = spec_lib.cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = cell.traffic['driver']
    driver = spec_lib.driver(kind)
    out = open(args.out, 'a') if args.out else None
    controls = set(_seeds(args.control_seeds))
    runs = [(s, None) for s in _seeds(args.seeds)]
    runs += [(s, None) for s in sorted(controls - set(_seeds(args.seeds)))]
    faults = FAULTS[kind] + tuple(faults_lib.of_nets(cell.config))
    runs += [(s, f) for s in _seeds(args.fault_seeds) for f in faults]
    for seed, fault in runs:
        t = time.time()
        if kind == 'train_fit':
            reading = train_readings(driver, cell, seed, args.device, fault,
                                     fault is None and seed in controls)
        else:
            reading = serve_readings(driver, cell, seed, args.device,
                                     args.seconds, fault,
                                     fault is None and seed in controls)
        reading = dict(workload=args.workload, seed=seed, fault=fault,
                       seconds=time.time() - t, **reading)
        line = json.dumps(reading, default=lambda v: str(v))
        line = line.replace('Infinity', '"inf"')
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
