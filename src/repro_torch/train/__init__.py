"""Training substrate: optimizers, checkpoint store, the real-training backend."""
