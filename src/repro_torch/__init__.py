"""PyTorch/CUDA port of the transfer tuner (offline knowledge discovery +
adaptive real-time sampling) for NVIDIA Hopper.

Mirrors the layout and names of the JAX package: ``netsim`` (the simulated
testbeds and Globus-schema logs), ``core`` (clustering, spline surfaces, the
offline DB, the adaptive sampler, the additive refit) and ``kernels`` (the
hand-written CUDA kernels, their plain-torch twins and the dispatch by
tensor device).  See ``device.resolve_device`` for the device rule.
"""
