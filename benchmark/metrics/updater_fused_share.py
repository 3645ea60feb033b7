"""Runtime and updater: the share of the parameter leaves the window's
updates sent to the multi-tensor adam kernel, fused leaves over all
leaves updated (``updater_leaves_total{path="fused"}`` over the series'
sum). 1 where adam's every leaf takes the kernel, 0 under another rule.
Nothing on a program without the counter."""


def read(run):
    total = run.delta("updater_leaves_total")
    if not total:
        return None
    return run.delta("updater_leaves_total", path="fused") / total
