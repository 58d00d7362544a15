"""Named spans at the serving path's layer boundaries.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and one shared ``contextlib.nullcontext()`` otherwise:
a span costs only the check when nothing traces, where an unguarded
``record_function`` costs some ten microseconds.  There is no switch of
its own: the spans are on exactly while ``torch.profiler`` records.  A
profiler that traces the device ties each device operation,
by its correlation id, to the runtime call that launched it and so to the
spans open on the launching thread at that moment.

Every name starts with ``repro.``.  Spans are per call, not per request:
a batch is the unit the program sees.
"""
from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "repro."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler records."""
    return record_function(name) if _profiler_enabled() else _OFF
