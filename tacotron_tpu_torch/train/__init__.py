"""Training: losses, the optimizer chain, the train and eval steps,
checkpoints and the driver (``python -m tacotron_tpu_torch.train``)."""
