"""Shared helpers of the parity tests that hold the PyTorch port
(``repro_torch``) to the JAX package (``repro``).

Both packages define their own dataclasses with the same names and fields,
so ``==`` across packages is always False; ``plain`` turns either side's
objects into the same plain structure (dataclasses into dicts tagged with
their class name, tuples into lists) so the two can be compared exactly.
"""
import dataclasses
import functools

import numpy as np


def plain(x):
    """Package-independent plain form of a value (exact, no rounding)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__class__": type(x).__name__,
                **{f.name: plain(getattr(x, f.name))
                   for f in dataclasses.fields(x) if f.compare}}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def assert_same(a, b):
    """Exact equality of two objects from either package."""
    pa, pb = plain(a), plain(b)
    assert pa == pb


def interpret_reference_kernels(monkeypatch):
    """Route the JAX package's kernel dispatch through its Pallas kernels in
    interpret mode, as its own tests run them on the CPU.  The three dispatch
    functions are looked up at call time by their callers, so binding
    ``interpret=True`` here reaches every ``use_pallas=True`` call site."""
    from repro.kernels import ops
    monkeypatch.setattr(ops, "cluster_assign",
                        functools.partial(ops.cluster_assign, interpret=True))
    monkeypatch.setattr(ops, "nat_spline_fit",
                        functools.partial(ops.nat_spline_fit, interpret=True))
    monkeypatch.setattr(ops, "transfer_predict_argmax",
                        functools.partial(ops.transfer_predict_argmax,
                                          interpret=True))
