"""``flash_attention``'s share of its roofline over the traced window: the
least time of every causal launch the traced prefills made
(``bench.roofline.flash_attention``, the causal half of the work) over the
device time of the ``flash_attention`` kernels in the trace."""
from bench import roofline
from bench.kernel_names import is_flash_attention


def read(run):
    cfg, tr = run.cell.cfg, run.trace
    if tr is None or not run.prefills:
        return None
    n = roofline.n_attention(cfg)
    if tr.op_count(is_flash_attention) != n * len(run.prefills):
        return None
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg["d_model"] // H
    least = n * sum(
        roofline.least_s(*roofline.flash_attention(p.batch, p.length, H,
                                                   Hkv, D))
        for p in run.prefills)
    return 100.0 * least / tr.op_seconds(is_flash_attention)
