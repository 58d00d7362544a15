"""The prefills' share of the card's roofline: the least time of each
prefill of the window (its operations over the bf16 peak or its bytes over
the bandwidth, whichever is larger; ``bench.roofline.prefill``) summed,
over the prefills' walls summed."""
from bench import roofline


def read(run):
    ps = run.prefills
    if not ps:
        return None
    least = sum(roofline.least_s(*roofline.prefill(run.cell.cfg, p.batch,
                                                   p.length)) for p in ps)
    return 100.0 * least / sum(p.wall_s for p in ps)
