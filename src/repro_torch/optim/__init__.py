"""AdamW with mixed-precision state, the cosine schedule, global-norm
clipping and the int8 codecs, as in ``repro.optim``."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.grad_utils import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "global_norm"]
