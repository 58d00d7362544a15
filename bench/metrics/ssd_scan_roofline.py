"""``ssd_scan``'s share of its roofline over the traced window: the least
time of every launch the traced prefills made (``bench.roofline.ssd_scan``
at the shapes the traffic gave: one a Mamba2 layer) over the device time
of the ``ssd_scan`` kernels in the trace."""
from bench import roofline
from bench.kernel_names import is_ssd_scan


def read(run):
    cfg, tr = run.cell.cfg, run.trace
    if tr is None or cfg["family"] != "hybrid" or not run.prefills:
        return None
    if tr.op_count(is_ssd_scan) != cfg["n_layers"] * len(run.prefills):
        return None
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = cfg["ssm_expand"] * cfg["d_model"] // P
    least = cfg["n_layers"] * sum(
        roofline.least_s(*roofline.ssd_scan(p.batch, p.length, H, P, N,
                                            min(cfg["ssm_chunk"], p.length)))
        for p in run.prefills)
    return 100.0 * least / tr.op_seconds(is_ssd_scan)
