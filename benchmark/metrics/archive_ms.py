"""archive_ms: the mean, over the window's epochs, of the trainer's own
``_stage/archive`` stage (its ``StageTimer``, reported to the benchmark's
reporter): the archive's inputs, the zeta re-evaluation and the submission
on the host, in ms an epoch.  Layer: the runner (``VectorizedTrainer.train``
and ``novelty/handler.py``)."""


def read(ctx):
    values = [r["_stage/archive"] for r in ctx.window.reports if "_stage/archive" in r]
    if not values:
        return None
    return 1e3 * sum(values) / len(values)
