"""The Mamba2 mixer's share of its roofline over the traced window: the
least time of every mixer the traced prefills ran
(``bench.roofline_layers.mamba2_mixer``, one a Mamba2 layer, at the
traffic's shapes) over the device time under the program's
``repro.mamba2`` spans (``bench.spans``), whatever implements the mixer;
nothing where the spans are not one a layer and prefill."""
from bench import roofline, roofline_layers, spans

SPAN = "repro.mamba2"


def read(run):
    cfg, at = run.cell.cfg, spans.linked(run.trace)
    if at is None or cfg["family"] != "hybrid" or not run.prefills \
            or at.inclusive[SPAN] <= 0:
        return None
    if at.counts[SPAN] != cfg["n_layers"] * len(run.prefills):
        return None
    least = cfg["n_layers"] * sum(
        roofline.least_s(*roofline_layers.mamba2_mixer(cfg, p.batch,
                                                        p.length))
        for p in run.prefills)
    return 100.0 * least / at.seconds(SPAN)
