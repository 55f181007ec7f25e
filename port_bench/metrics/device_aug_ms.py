"""Device augmentation, ms a step: CUDA events around the trainer's
`aug_fn` (the port's `DeviceAugment`) on every step of the window, the
mean over the steps."""


def read(ctx):
    a = ctx.counters.aug_ms
    return sum(a) / len(a) if a else None
