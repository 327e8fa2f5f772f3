"""setup_s: the seconds from the process's start to the window's opening:
imports, the level tables, the trainer and its inputs, and the check's
epochs, the first of which builds or loads every kernel."""


def read(ctx):
    return ctx.setup_s
