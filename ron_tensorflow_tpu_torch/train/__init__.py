"""Training: optimizers and schedules, train state and step, checkpoints,
the trainer."""
