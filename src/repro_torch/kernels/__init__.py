"""Hand-written CUDA kernels for Hopper, their plain-torch versions, and the
dispatch between them by tensor device."""
