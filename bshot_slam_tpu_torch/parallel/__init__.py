"""Multi-device execution on `torch.distributed` (see `sharded`)."""
