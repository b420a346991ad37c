from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import (all_steps, latest_step, restore,
                                          restore_latest, save)

__all__ = ["store", "all_steps", "latest_step", "restore", "restore_latest",
           "save"]
