"""Per cent of the traced window of a decode run in which no operation ran
on the device while the main thread was inside one of the program's
``repro.*`` spans (``bench.spans``): the part of ``idle_share.decode``
that the program's own host work leaves."""
from bench import spans

SPAN = "repro.decode"


def read(run):
    tr = run.trace
    if tr is None or run.cell.mix["kind"] != "decode" or tr.window_s <= 0:
        return None
    at = spans.of(tr)
    if not at.counts[SPAN]:
        return None
    return 100.0 * at.idle_in_program_ns * 1e-9 / tr.window_s
