"""launches_per_epoch: the kernel launches the profiler recorded (the
runtime's and the driver's launch calls) in the traced window, over its
epochs.  Layer: the rollout loop."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.on_card or t.launches == 0:
        return None
    return t.launches / t.epochs
