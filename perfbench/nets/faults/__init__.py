"""A net's own faults, ``nets/faults/<net>.py``: ``faults``, ``{name:
plant(model)}``, each planted in the port's model under the timed path
(``harness/faults.py``). They alone of ``perfbench/nets`` reach into the
port; a net's module (``nets/<net>.py``) is the reference's and imports
nothing of it."""
