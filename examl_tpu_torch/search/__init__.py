"""The RAxML SPR search, its snapshots and checkpoints."""
