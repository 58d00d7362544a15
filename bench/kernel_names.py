"""Which device operations of a trace belong to which layer, by name."""
from __future__ import annotations


def is_flash_attention(name: str) -> bool:
    """The port's ``csrc/flash_attention.cu`` kernels."""
    return "flash_attention" in name


def is_ssd_scan(name: str) -> bool:
    """The port's ``csrc/ssd_scan.cu`` kernels."""
    return "ssd_scan" in name


def is_plain(name: str) -> bool:
    """PyTorch's own non-GEMM work: ATen's ``at::native`` kernels
    (elementwise, reductions, softmax, indexing, copies, concatenation)
    and the runtime's copies and sets.  cuBLAS's GEMMs and the port's
    hand-written kernels fall outside."""
    return ("at::native::" in name or name.startswith("Memcpy")
            or name.startswith("Memset"))
