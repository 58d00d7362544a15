"""Prompt tokens taken plus tokens generated, over the window's time."""


def read(run):
    return run.tokens / run.window_s if run.tokens else None
