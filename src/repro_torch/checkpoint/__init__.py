from repro_torch.checkpoint.checkpoint import (CheckpointManager, latest_step,
                                               restore_checkpoint,
                                               save_checkpoint, snapshot,
                                               state_from_tree)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "snapshot", "state_from_tree"]
