"""Per cent of the traced window of a decode run in which no operation ran
on the device (the union of the operations' intervals taken as busy)."""
from bench.metrics._shares import idle_share


def read(run):
    return idle_share(run, "decode")
