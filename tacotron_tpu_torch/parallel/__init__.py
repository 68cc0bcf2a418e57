"""Host-to-device overlap for training (one card; multi-GPU is not ported
yet)."""
