"""Named ranges inside the port's training path, for `torch.profiler`.

``span(name)`` opens ``torch.profiler.record_function("repro_torch." +
name)`` while some `torch.profiler` is running in the thread, and is one
shared no-op context otherwise. A span exists only under a profiler: there
is no flag, no store and no exporter. The ranges land in the profiler's
trace on the clock of the device's activity, so a reader ties the kernels
launched inside a range to it by correlation id. With no profiler running
a span costs one check of the profiler's state; it enters no
`RecordFunction`, so no dispatch mode (the dry run's `Accountant`) sees it.

The spans, and the code each wraps:

* ``repro_torch.step``: the whole train step (`launch/steps.py`
  `make_train_step`'s ``train_step``);
* ``repro_torch.step.forward``: `api.loss_fn`, once a microbatch;
* ``repro_torch.step.backward``: ``loss.backward()``, once a microbatch;
* ``repro_torch.step.clip``: `clip_by_global_norm`;
* ``repro_torch.step.optimizer``: the optimizer's ``update``;
* ``repro_torch.ssd_bwd``: the SSD scan's backward (`kernels/ops.py`
  ``_SSDScan.backward``), once an SSD layer a backward; it runs on
  autograd's thread, which inherits the profiler from the caller's;
* ``repro_torch.trainer.batch``: the loader's next global batch and its
  copy to the trainer's device (`core/trainer.py` ``run_steps``).

An operator sees them by running any profiler around ``run_steps``::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run_steps(state, 5)
    prof.export_chrome_trace("steps.json")
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

#: what `span` returns while no profiler runs (reusable: it holds no state)
OFF = contextlib.nullcontext()


def span(name: str):
    """A ``repro_torch.<name>`` range while a profiler runs, else `OFF`."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return OFF
