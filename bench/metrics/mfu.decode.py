"""The decode steps' share of the card's roofline: each step's least time
(the weights and the valid cache entries read once over the bandwidth, or
its operations over the bf16 peak; ``bench.roofline.decode_step``) summed,
over the steps' walls summed."""
from bench import roofline


def read(run):
    steps = run.steps
    if not steps:
        return None
    least = sum(roofline.least_s(*roofline.decode_step(run.cell.cfg, s.batch,
                                                       s.valid))
                for s in steps)
    return 100.0 * least / sum(s.wall_s for s in steps)
