"""RMSNorm's share of its roofline over the traced window of a dense
model's prefills: the least time of every RMSNorm the traced prefills ran
(``bench.roofline_layers.rms_norm``: two a layer at B x S rows and the
head's at B rows) over the device time under the program's
``repro.rms_norm`` spans (``bench.spans``), whatever implements the norm;
nothing where the spans are not 2 a layer and 1 a prefill."""
from bench import roofline, roofline_layers, spans

SPAN = "repro.rms_norm"


def read(run):
    cfg, at = run.cell.cfg, spans.linked(run.trace)
    if at is None or cfg["family"] != "dense" or not run.prefills \
            or run.steps or at.inclusive[SPAN] <= 0:
        return None
    L, d = cfg["n_layers"], cfg["d_model"]
    if at.counts[SPAN] != (2 * L + 1) * len(run.prefills):
        return None
    least = sum(
        2 * L * roofline.least_s(*roofline_layers.rms_norm(p.batch * p.length,
                                                          d))
        + roofline.least_s(*roofline_layers.rms_norm(p.batch, d))
        for p in run.prefills)
    return 100.0 * least / at.seconds(SPAN)
