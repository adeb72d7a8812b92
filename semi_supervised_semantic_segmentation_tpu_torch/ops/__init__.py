"""Device ops: augmentation, losses, resize, schedules and the kernels."""
