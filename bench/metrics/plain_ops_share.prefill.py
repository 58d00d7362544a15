"""Per cent of the device's operation time, over the traced window of a
prefill run, in PyTorch's own non-GEMM kernels (``bench.kernel_names.is_plain``)."""
from bench.metrics._shares import plain_share


def read(run):
    return plain_share(run, "prefill")
