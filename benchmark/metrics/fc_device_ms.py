"""fc_device_ms: the program's ``fc`` span (``ImpalaPolicy._fc``: the ReLU,
flatten, BN, the fc layer with its bf16 rounding, ReLU, in every torso call
of the epoch) on the device, ``_stage/fc.device`` from its CUDA events,
summed over the window's reports, in ms an epoch.  Layer: the rollout loop."""

KEY = "_stage/fc.device"


def read(ctx):
    reports = ctx.window.reports
    if not any(KEY in r for r in reports):
        return None
    return 1e3 * sum(r.get(KEY, 0.0) for r in reports) / len(reports)
