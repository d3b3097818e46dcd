from repro_torch.data.pipeline import (SyntheticLMConfig, SyntheticLM,
                                       make_batch, make_global_batch)

__all__ = ["SyntheticLMConfig", "SyntheticLM", "make_batch",
           "make_global_batch"]
