"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window, its
count reset at the opening, in GiB.  Layer: the epoch step."""


def read(ctx):
    if not ctx.on_card:
        return None
    return ctx.window_peak_bytes / 2 ** 30
