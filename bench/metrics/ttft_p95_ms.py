"""The 95th percentile of time to first token over every request the
window completed: from the batch handed to the entry to its first tokens
on the host."""
from bench.harness import percentile


def read(run):
    return percentile(run.ttft_s, 95) * 1e3 if run.ttft_s else None
