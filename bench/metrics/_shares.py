"""Shares of the traced window that several readers take."""
from bench.kernel_names import is_plain


def plain_share(run, kind: str):
    """Per cent of the device's operation time in ``is_plain`` kernels, in
    a run whose traffic is of ``kind``."""
    tr = run.trace
    if tr is None or run.cell.mix["kind"] != kind:
        return None
    total = tr.op_seconds(lambda n: True)
    return 100.0 * tr.op_seconds(is_plain) / total if total > 0 else None


def idle_share(run, kind: str):
    """Per cent of the traced window with no device operation running."""
    tr = run.trace
    if tr is None or run.cell.mix["kind"] != kind or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
