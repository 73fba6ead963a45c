"""Optimizer and gradient codecs of the training loop: AdamW with float32 master
weights (:mod:`~repro_torch.optim.adamw`) and error-feedback gradient compression
(:mod:`~repro_torch.optim.compress`)."""
