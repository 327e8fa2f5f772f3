"""mfu: the model operations of the window's work (``arch.window_flops``:
a forward for each env step the trainer counted, the novelty's and the
archive's forwards over zeta, and 2 operations a parameter a member for the
perturbation and for the combine) over the window's seconds at the
configuration's peak product rate (``benchmark/peaks.py``), in %.  Layer:
the whole epoch step."""

from benchmark import peaks


def read(ctx):
    if not ctx.on_card:
        return None
    w = ctx.window
    flop = ctx.cell.arch.window_flops(ctx.config, ctx.workload, w.env_steps, w.epochs)
    return 100.0 * flop / (w.seconds * peaks.flops(ctx.config["compute_dtype"]))
