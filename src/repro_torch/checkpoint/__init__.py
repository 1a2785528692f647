from .store import CheckpointError, latest_step, manifest_for, restore, save

__all__ = ["CheckpointError", "latest_step", "manifest_for", "restore",
           "save"]
