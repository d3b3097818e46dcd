from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa
