"""Launch calls the host made inside the program's ``repro.decode`` spans
(``bench.spans.calls_under``), over the traced decode steps: what each
step hands the runtime's launch queue.  A kernel launch, a copy, a set or
a CUDA graph's replay counts one."""
from bench import spans

SPAN = "repro.decode"


def read(run):
    if run.trace is None:
        return None
    calls, steps = spans.calls_under(run.trace, SPAN)
    return calls / steps if steps else None
