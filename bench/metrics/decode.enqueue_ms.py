"""Host time from a decode step's start to ``Model.decode`` returning,
before the step waits for the device: a mean over the window's steps."""


def read(run):
    steps = run.steps
    return 1e3 * sum(s.enqueue_s for s in steps) / len(steps) if steps else None
