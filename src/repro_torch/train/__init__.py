"""LM training steps: the loss, gradient accumulation over microbatches and
the optimizer update, on one device."""
