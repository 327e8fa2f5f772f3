"""idle_share: 100 x (1 - the union of the device operations' intervals in
the traced window over the window's wall time), in %.  Layer: the device."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.on_card or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
