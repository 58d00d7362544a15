"""The 95th percentile of the gap between output tokens over every decode
step of the window: the step's wall until its tokens are on the host."""
from bench.harness import percentile


def read(run):
    walls = [s.wall_s for s in run.steps]
    return percentile(walls, 95) * 1e3 if walls else None
