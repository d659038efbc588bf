"""The LM model zoo of the port: configs, the decoder / encoder-decoder
stack over attention (GQA, local, cross, MLA), MoE, Mamba-2 SSD and
RG-LRU mixers, and the decode step the serving loop runs."""

from repro_torch.models.common import (ModelConfig, MoEConfig, MLAConfig,
                                       SSMConfig, RGLRUConfig, count_params)
from repro_torch.models.transformer import (init_params,
                                            init_params_and_axes, forward,
                                            encode, init_caches, decode_step,
                                            group_structure)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "RGLRUConfig", "count_params", "init_params",
           "init_params_and_axes", "forward", "encode", "init_caches",
           "decode_step", "group_structure"]
