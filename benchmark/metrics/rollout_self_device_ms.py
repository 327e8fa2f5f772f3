"""rollout_self_device_ms: the program's ``rollout`` span on the device less
the spans inside it (``torso``, ``fc``, ``core``, ``env``), its
``_stage/rollout.self.device`` from its CUDA events, summed over the
window's reports, in ms an epoch: the per-step bookkeeping (the ``where``s
that freeze done episodes, the accumulators), the reset and the weights'
preparation.  Layer: the rollout loop (``fd/rollout.py``)."""

KEY = "_stage/rollout.self.device"


def read(ctx):
    reports = ctx.window.reports
    if not any(KEY in r for r in reports):
        return None
    return 1e3 * sum(r.get(KEY, 0.0) for r in reports) / len(reports)
