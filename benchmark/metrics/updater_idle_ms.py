"""Runtime and updater: per host-profiled step, the time inside the
program's ``fit.updater`` ranges in which the card ran nothing (the
ranges less the merged intervals of device activity in the same
profile): the part of the updater phase in which the device starves.
None where the program marks no such range or the profile holds no
device activity."""


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(span, busy):
    s, e = span
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in busy
               if a < e and b > s)


def read(run):
    trace = run.trace
    if trace is None or not trace.steps or not trace.host_device:
        return None
    ranges = _merged([(e.time_range.start, e.time_range.end)
                      for e in trace.cpu if e.name == "fit.updater"])
    if not ranges:
        return None
    busy = _merged([(e.time_range.start, e.time_range.end)
                    for e in trace.host_device])
    idle_us = sum(e - s - _covered((s, e), busy) for s, e in ranges)
    return 1e-3 * idle_us / trace.steps
