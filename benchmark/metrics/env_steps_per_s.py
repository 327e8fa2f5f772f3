"""env_steps_per_s: the env steps the trainer counted in the window (the
difference of its cumulative count) over the window's wall seconds on the
host clock; the archive's host time between epochs is inside it."""


def read(ctx):
    return ctx.window.env_steps / ctx.window.seconds
