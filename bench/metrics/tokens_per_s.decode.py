"""Tokens generated, and prompt tokens taken, over the window's time, in a
decode cell: the rate at which the decode pool serves its requests."""


def read(run):
    return run.tokens / run.window_s if run.tokens else None
