"""The optimizer and the gradient compression of the LM training step."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, global_norm,
                                     init, schedule, update)
from repro_torch.optim.grad_compress import (ErrorFeedbackState,
                                             compress_int8, decompress_int8,
                                             ef_init, ef_step)

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "schedule",
           "global_norm", "compress_int8", "decompress_int8",
           "ErrorFeedbackState", "ef_init", "ef_step"]
