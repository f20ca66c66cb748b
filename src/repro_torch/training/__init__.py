"""Training, twin of `repro.training`: the optimizers (`optimizer`) and the
train and eval steps (`train_step`)."""
