from repro_torch.checkpoint.store import (CheckpointManager, save_checkpoint,
                                          restore_checkpoint, latest_step)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
