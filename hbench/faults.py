"""Faults planted in the program under a run, for the checks that have to
catch them (`calibrate.py` on the card, `tests/test_hbench_faults.py` on the
CPU): each a context manager that patches one function of the port and
restores it on exit. Nothing here is imported by a benchmark run.

- `unchanged`: every optimizer step returns the state it was given;
- `half_batch`: each step's loss is the mean over half of its batch (the
  first half of the positives and of the negatives), the rest left out.

The cells run on one chip and train (no exchange between chips, no token
or answer to alter), so these are the faults they can have.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextlib.contextmanager
def unchanged():
    from linkpred_tpu_torch.models import twowl as m

    def no_step(self, closure=None):
        return None

    with _patched(torch.optim.Adam, "step", no_step), \
            _patched(m, "adam_trials_update", lambda *a, **k: None):
        yield


@contextlib.contextmanager
def half_batch():
    from linkpred_tpu_torch.models import twowl as m

    step_inputs = m._step_inputs

    def half_step_inputs(pos_ids, neg_ids, *args, **kwargs):
        return step_inputs(pos_ids[: len(pos_ids) // 2],
                           neg_ids[: len(neg_ids) // 2], *args, **kwargs)

    with _patched(m, "_step_inputs", half_step_inputs):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
