"""Checkpoints and posterior-bank snapshots, in the reference's format."""
from repro_torch.checkpoint.checkpoint import (latest_bank_step,  # noqa: F401
                                               latest_step, load_bank,
                                               load_checkpoint,
                                               load_checkpoint_tree,
                                               save_bank, save_checkpoint)
