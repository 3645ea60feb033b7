"""Timeline collector: merge per-process span exports into one ordered
fleet timeline (per elastic round) or per-request decode timeline.

A copy of the JAX package's ``util/timeline.py`` (host code, no JAX math):
the same spans give the same dict and text in both packages.

The tracing substrate (:mod:`.tracing`) produces spans per PROCESS; this
module is the read side that crosses the process boundary, in the
Dapper/MegaScale shape: every participant exports its spans (per-host
JSONL from a tracer, ``trace_<host>.json`` records an elastic host
publishes next to its round's REDUCE record), and the collector merges
them by ``trace_id``/``round`` into one report that names, per round,
the CRITICAL-PATH host and the phase it spent its time in — the
full-attribution upgrade of the flight recorder's "stall names the
blocking host" event.

Inputs are deliberately forgiving: a host killed mid-run exported only
the rounds it finished (the store records survive the process), a
replayed round overwrote its record with the replay's timings, and a
round with no REDUCE record yet still renders from whatever spans exist.
Wall-clock (``start_unix``) orders events ACROSS hosts — adequate within
one machine or an NTP-disciplined fleet; skew shows up as impossible
orderings, not wrong durations (durations are monotonic-clock).

Three entry points:

- :func:`build_fleet_timeline` — store + JSONL exports → per-round
  attribution report (``python -m deeplearning4j_tpu_torch.util.timeline``).
- :func:`request_timelines` — a tracer's decode spans → one nested
  timeline per served request (TTFT decomposition attached by the
  scheduler, see ``serving/decode.py``).
- :func:`trace_summaries` — everything a tracer holds, grouped by trace
  and nested by parentage (``GET /debug/timeline`` on both servers).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# phases whose spans gate a host's publish for round r: its own compute
# this round, plus the previous round's correction tail that delayed
# this round's start
_ROUND_PHASES = ("local_steps", "publish")
_PREV_TAIL_PHASES = ("wait", "reduce", "apply")


def _as_dict(span) -> dict:
    return span if isinstance(span, dict) else span.to_dict()


def _end_unix(s: dict) -> float:
    return float(s.get("start_unix") or 0.0) + \
        float(s.get("duration_ms") or 0.0) / 1000.0


def load_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _expand_jsonl(patterns: Sequence[str]) -> List[str]:
    """Globs expanded forgivingly: an unmatched pattern contributes
    nothing (a fleet where every child died before exporting must still
    render from the store records), a literal existing path passes
    through."""
    import os as _os
    out = []
    for pattern in patterns:
        matched = sorted(_glob.glob(pattern))
        if matched:
            out.extend(matched)
        elif _os.path.exists(pattern):
            out.append(pattern)
    return out


def _dedupe(spans: Iterable[dict]) -> List[dict]:
    seen, out = set(), []
    for s in spans:
        sid = s.get("span_id")
        if sid in seen:
            continue
        seen.add(sid)
        out.append(s)
    return out


# ----------------------------------------------------------------------
# fleet timeline
# ----------------------------------------------------------------------

def _coerce_store(store):
    if store is None or not isinstance(store, str):
        return store
    from ..parallel.elastic import FileCoordinationStore
    return FileCoordinationStore(store)


def _store_rounds(store) -> List[Tuple[int, List[dict], Optional[dict]]]:
    """(round, trace_records, reduce_record) per dense round, from 0."""
    out = []
    r = 0
    while True:
        prefix = f"rounds/r{r:06d}"
        keys = store.list(prefix)
        if not keys:
            break
        traces, reduce_rec = [], None
        for key in keys:
            name = key.rsplit("/", 1)[-1]
            if name == "REDUCE.json":
                reduce_rec = store.get_json(key)
            elif name.startswith("trace_") and name.endswith(".json"):
                doc = store.get_json(key)
                if doc is not None:
                    traces.append(doc)
        out.append((r, traces, reduce_rec))
        r += 1
    return out


def _membership_log(store) -> List[dict]:
    recs = []
    for key in store.list("log"):
        doc = store.get_json(key)
        if doc is not None:
            recs.append(doc)
    recs.sort(key=lambda d: int(d.get("seq", 0)))
    return recs


def _round_of(span: dict) -> Optional[int]:
    r = (span.get("attributes") or {}).get("round")
    return None if r is None else int(r)


def build_fleet_timeline(store=None, jsonl_paths: Sequence[str] = (),
                         spans: Optional[Iterable] = None) -> dict:
    """Merge an elastic run's trace exports into one fleet timeline.

    ``store`` is the run's coordination store (object or directory
    path); ``jsonl_paths`` are per-host tracer exports (globs allowed);
    ``spans`` adds in-memory spans (Span objects or dicts). Any subset
    works — store records cover rounds the process died before
    exporting, JSONL covers spans the store never saw.

    Per round the report names the critical-path host and phase:

    - a host hard-evicted while the round was blocked on it
      (``blocked_round`` on the eviction record) → ``evicted``;
    - a member with no publish span in the merged set → ``missing``
      (it gated the reduce and left no trace);
    - otherwise the member whose ``publish`` ended last, attributed to
      its longest gating phase — this round's ``local_steps``/``publish``
      or the previous round's ``wait``/``reduce``/``apply`` tail that
      delayed this round's start. A wait-dominated critical host means
      the real bottleneck is upstream (it was itself blocked).
    """
    store = _coerce_store(store)
    all_spans: List[dict] = [_as_dict(s) for s in (spans or [])]
    for p in _expand_jsonl(jsonl_paths):
        all_spans.extend(load_jsonl(p))

    reduce_recs: Dict[int, dict] = {}
    # (round, host) -> spans, merged from store records + JSONL exports
    by_rh: Dict[Tuple[int, str], List[dict]] = {}
    incarnations: Dict[Tuple[int, str], int] = {}
    log: List[dict] = []
    if store is not None:
        for r, traces, reduce_rec in _store_rounds(store):
            if reduce_rec is not None:
                reduce_recs[r] = reduce_rec
            for rec in traces:
                h = rec.get("host")
                by_rh.setdefault((r, h), []).extend(rec.get("spans") or [])
                if rec.get("incarnation") is not None:
                    incarnations[(r, h)] = int(rec["incarnation"])
        log = _membership_log(store)
    # JSONL spans group by their CONTAINING round (parent link), same as
    # the store records — a wait span's ``round`` attribute names the
    # round it waited FOR (j = r - s), not the round it ran in
    round_of_span: Dict[str, Tuple[int, str]] = {}
    for s in all_spans:
        if s.get("name") == "elastic.round" and _round_of(s) is not None:
            round_of_span[s["span_id"]] = (_round_of(s), s.get("host"))
    for s in all_spans:
        name = s.get("name")
        if name == "elastic.round":
            key = round_of_span[s["span_id"]]
        elif name in _ROUND_PHASES + _PREV_TAIL_PHASES:
            key = round_of_span.get(s.get("parent_id"))
            if key is None and name in _ROUND_PHASES:
                # round span lost (truncated export): local_steps and
                # publish carry their containing round themselves
                r = _round_of(s)
                key = None if r is None else (r, s.get("host"))
            if key is None:
                continue        # tail-flush/catchup span outside a round
        else:
            continue
        by_rh.setdefault(key, []).append(s)
    for key, group in by_rh.items():
        by_rh[key] = sorted(_dedupe(group),
                            key=lambda s: s.get("start_unix") or 0.0)

    rounds = sorted({r for r, _h in by_rh} | set(reduce_recs))
    hosts = sorted({h for _r, h in by_rh if h})
    evicts = [rec for rec in log if rec.get("event") == "evict"]

    def _spans_of(r: int, h: str, names: Tuple[str, ...]) -> List[dict]:
        return [s for s in by_rh.get((r, h), ())
                if s.get("name") in names]

    out_rounds = []
    for r in rounds:
        reduce_rec = reduce_recs.get(r)
        members = (list(reduce_rec["members"]) if reduce_rec
                   else sorted({h for (rr, h) in by_rh if rr == r}))
        host_rows: Dict[str, dict] = {}
        for h in sorted({h for (rr, h) in by_rh if rr == r} |
                        set(members)):
            group = by_rh.get((r, h), [])
            round_spans = sorted(
                [s for s in group if s.get("name") == "elastic.round"],
                key=lambda s: s.get("start_unix") or 0.0)
            # an interrupted-then-resumed round leaves spans from BOTH
            # attempts in a same-process tracer export: the row reports
            # the LATEST attempt (phase spans selected by parentage),
            # not a sum over attempts
            if round_spans:
                rs = round_spans[-1]
                phase_spans = [s for s in group
                               if s.get("parent_id") == rs["span_id"]]
            else:
                rs = None
                phase_spans = [s for s in group
                               if s.get("name") != "elastic.round"]
            phases: Dict[str, float] = {}
            for s in phase_spans:
                phases[s["name"]] = (phases.get(s["name"], 0.0)
                                     + float(s.get("duration_ms") or 0.0))
            row = {"phases_ms": {k: round(v, 3)
                                 for k, v in phases.items()},
                   "member": h in members}
            if rs is not None:
                row.update(start_unix=rs.get("start_unix"),
                           end_unix=_end_unix(rs),
                           duration_ms=rs.get("duration_ms"),
                           trace_id=rs.get("trace_id"),
                           replay=(rs.get("attributes") or {})
                           .get("replay", False),
                           attempts=len(round_spans))
            if (r, h) in incarnations:
                row["incarnation"] = incarnations[(r, h)]
            host_rows[h] = row

        # -- critical-path attribution --------------------------------
        blocked_evicts = [rec for rec in evicts
                          if rec.get("blocked_round") == r]
        critical_host = critical_phase = None
        if blocked_evicts:
            critical_host = blocked_evicts[-1]["host"]
            critical_phase = "evicted"
        else:
            pub_end: Dict[str, float] = {}
            for h in members:
                pubs = _spans_of(r, h, ("publish",))
                if not pubs:
                    critical_host, critical_phase = h, "missing"
                    break
                pub_end[h] = max(_end_unix(s) for s in pubs)
            if critical_host is None and pub_end:
                critical_host = max(sorted(pub_end), key=pub_end.get)
                cands = _spans_of(r, critical_host, _ROUND_PHASES) + \
                    _spans_of(r - 1, critical_host, _PREV_TAIL_PHASES)
                critical_phase = (max(
                    cands, key=lambda s: s.get("duration_ms") or 0.0)
                    ["name"] if cands else "unattributed")

        events = [rec for rec in log
                  if rec.get("blocked_round") == r
                  or rec.get("effective_round") == r]
        entry = {"round": r, "members": members,
                 "critical_host": critical_host,
                 "critical_phase": critical_phase,
                 "hosts": host_rows}
        if reduce_rec is not None:
            entry["reduce_by"] = reduce_rec.get("by")
        if events:
            entry["events"] = events
        out_rounds.append(entry)

    trace_ids = sorted({s.get("trace_id")
                        for group in by_rh.values() for s in group
                        if s.get("trace_id")})
    return {"rounds": out_rounds, "hosts": hosts, "events": log,
            "trace_ids": trace_ids,
            "n_spans": sum(len(v) for v in by_rh.values())}


def render_fleet_text(tl: dict) -> str:
    lines = [f"fleet timeline: {len(tl['hosts'])} hosts "
             f"({', '.join(tl['hosts'])}), {len(tl['rounds'])} rounds, "
             f"traces: {', '.join(t[:12] for t in tl['trace_ids'])}"]
    for rd in tl["rounds"]:
        lines.append(
            f"round {rd['round']}: members={','.join(rd['members'])} "
            f"critical={rd['critical_host']} "
            f"phase={rd['critical_phase']}")
        for h, row in sorted(rd["hosts"].items()):
            phases = " ".join(f"{k}={v:.1f}ms"
                              for k, v in row["phases_ms"].items())
            extra = " REPLAY" if row.get("replay") else ""
            dur = row.get("duration_ms")
            dur_s = f" total={dur:.1f}ms" if dur is not None else ""
            lines.append(f"  {h}:{dur_s} {phases}{extra}")
        for ev in rd.get("events", ()):
            lines.append(
                f"  ! {ev['event']} {ev['host']} "
                f"effective_round={ev.get('effective_round')} "
                f"by={ev.get('by')} trace={str(ev.get('trace_id'))[:12]}")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# per-trace / per-request timelines
# ----------------------------------------------------------------------

def _nest(spans: List[dict]) -> Tuple[List[dict], Dict[str, dict]]:
    """Parent-link nesting: returns (roots, node map). Roots are spans
    whose parent is absent from the set (a remote parent is a valid
    root locally)."""
    nodes = {s["span_id"]: {**s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = nodes[s["span_id"]]
        parent = nodes.get(s.get("parent_id"))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n.get("start_unix") or 0.0)
    roots.sort(key=lambda n: n.get("start_unix") or 0.0)
    return roots, nodes


def _group_by_trace(spans_or_tracer, trace_id: Optional[str]
                    ) -> Dict[str, List[dict]]:
    """The one copy of the span intake both payload halves share:
    unwrap a Tracer, dict-ify, filter by trace id, group by trace."""
    spans = getattr(spans_or_tracer, "finished", spans_or_tracer)
    by_trace: Dict[str, List[dict]] = {}
    for s in spans:
        d = _as_dict(s)
        if trace_id is not None and d.get("trace_id") != trace_id:
            continue
        by_trace.setdefault(d["trace_id"], []).append(d)
    return by_trace


def trace_summaries(spans_or_tracer,
                    trace_id: Optional[str] = None) -> List[dict]:
    """Group spans by trace and nest by parentage — the generic
    ``/debug/timeline`` payload. ``spans_or_tracer`` is a Tracer, an
    iterable of Spans, or an iterable of span dicts."""
    by_trace = _group_by_trace(spans_or_tracer, trace_id)
    out = []
    for tid, group in by_trace.items():
        group = _dedupe(group)
        roots, _nodes = _nest(group)
        out.append({"trace_id": tid, "n_spans": len(group),
                    "start_unix": min((s.get("start_unix") or 0.0)
                                      for s in group),
                    "spans": roots})
    out.sort(key=lambda t: t["start_unix"])
    return out


def request_timelines(spans_or_tracer, root_name: str = "decode.request",
                      trace_id: Optional[str] = None) -> List[dict]:
    """One nested timeline per served decode request: the request span
    (with the scheduler's TTFT decomposition in its attributes) plus its
    queue/prefill/block children, ordered by submit time. Selected by
    NAME anywhere in the trace tree — a request parented on a caller's
    span that lives in the same tracer is still a request."""
    by_trace = _group_by_trace(spans_or_tracer, trace_id)
    out = []
    for tid, group in by_trace.items():
        _roots, nodes = _nest(_dedupe(group))
        for node in nodes.values():
            if node["name"] != root_name:
                continue
            out.append({"trace_id": tid,
                        "start_unix": node.get("start_unix"),
                        "duration_ms": node.get("duration_ms"),
                        "attributes": node.get("attributes", {}),
                        "status": node.get("status"),
                        "spans": node})
    out.sort(key=lambda t: t.get("start_unix") or 0.0)
    return out


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.util.timeline",
        description="Merge elastic-fleet trace exports into one ordered "
                    "per-round attribution timeline, or render decode "
                    "request timelines from a tracer JSONL export.")
    p.add_argument("--store", help="coordination-store directory of the "
                                   "elastic run (FileCoordinationStore)")
    p.add_argument("--jsonl", nargs="*", default=[],
                   help="per-host tracer JSONL exports (globs ok)")
    p.add_argument("--requests", action="store_true",
                   help="render decode request timelines from --jsonl "
                        "instead of a fleet timeline")
    p.add_argument("--trace-id", help="restrict to one trace id")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit JSON instead of text")
    args = p.parse_args(argv)
    if not args.store and not args.jsonl:
        p.error("need --store and/or --jsonl")
    if args.requests:
        spans = [s for g in _expand_jsonl(args.jsonl)
                 for s in load_jsonl(g)]
        reqs = request_timelines(spans, trace_id=args.trace_id)
        if args.as_json:
            print(json.dumps(reqs, indent=2))
        else:
            for r in reqs:
                a = r["attributes"]
                print(f"request {r['trace_id'][:12]} "
                      f"dur={r['duration_ms']:.1f}ms "
                      f"tokens={a.get('tokens')} "
                      f"finish={a.get('finish_reason')} "
                      f"ttft_ms={a.get('ttft_ms')}")
        return 0
    tl = build_fleet_timeline(store=args.store, jsonl_paths=args.jsonl)
    print(json.dumps(tl, indent=2, default=repr) if args.as_json
          else render_fleet_text(tl))
    return 0


if __name__ == "__main__":
    sys.exit(main())
