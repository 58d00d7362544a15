"""``decode_attention``'s share of its roofline over the traced window:
the least time of every decode attention the traced steps made
(``bench.roofline_layers.decode_attention`` at each step's batch and
valid positions, one an attention layer) over the device time under the
program's ``repro.decode_attend`` spans (``bench.spans``), whatever
implements it; nothing where the spans are not one a layer and step."""
from bench import roofline, roofline_layers, spans

SPAN = "repro.decode_attend"


def read(run):
    cfg, at = run.cell.cfg, spans.linked(run.trace)
    if at is None or not run.steps or at.inclusive[SPAN] <= 0:
        return None
    n = roofline.n_attention(cfg)
    if at.counts[SPAN] != n * len(run.steps):
        return None
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    D = cfg["d_model"] // H
    least = n * sum(
        roofline.least_s(*roofline_layers.decode_attention(
            s.batch, s.valid, H, Hkv, D))
        for s in run.steps)
    return 100.0 * least / at.seconds(SPAN)
