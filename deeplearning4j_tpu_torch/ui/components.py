"""UI components DSL: server-side chart/table/text components that
serialize to JSON and render to standalone HTML.

Parity: reference ``deeplearning4j-ui-components`` —
``components/chart/ChartLine.java``, ``ChartHistogram.java``,
``ChartTimeline.java``, ``ChartScatter.java``, ``table/ComponentTable.java``,
``text/ComponentText.java``, ``component/ComponentDiv.java`` and
``standalone/StaticPageUtil.java`` (render a component list into one
self-contained HTML page). The reference serialized components to JSON for
a JS renderer; here rendering is server-side inline SVG so the output needs
no script assets — same contract (build components anywhere, ship one file),
no dependency. Counterpart of the JAX package's ``ui/components.py``: the
same inputs give the same JSON and the same HTML.

Used by :meth:`..parallel.stats.TrainingStats.export_html` the way Spark
training stats used ui-components for ``StatsUtils.exportStatsAsHtml``.
"""

from __future__ import annotations

import html as _html
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, type] = {}

_PALETTE = ["#4c78a8", "#f58518", "#54a24b", "#e45756", "#72b7b2",
            "#b279a2", "#eeca3b", "#9d755d"]


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


class Component:
    """Base: every component serializes to ``{"type": ..., ...fields}`` and
    renders itself to an SVG/HTML fragment."""

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in self.__dict__.items()}
        d["type"] = type(self).__name__
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Component":
        d = dict(d)
        t = d.pop("type")
        try:
            cls = _REGISTRY[t]
        except KeyError:
            raise ValueError(f"unknown component type {t!r}") from None
        obj = cls.__new__(cls)
        obj.__dict__.update(d)
        return obj

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))

    def render(self) -> str:  # HTML fragment
        raise NotImplementedError


def _axes(width, height, pad, xmin, xmax, ymin, ymax) -> Tuple[str, Any, Any]:
    """Axis frame + tick labels; returns (svg fragment, sx, sy mappers)."""
    xspan = (xmax - xmin) or 1.0
    yspan = (ymax - ymin) or 1.0
    sx = lambda x: pad + (x - xmin) / xspan * (width - 2 * pad)
    sy = lambda y: height - pad - (y - ymin) / yspan * (height - 2 * pad)
    frag = (f'<rect x="{pad}" y="{pad}" width="{width - 2 * pad}" '
            f'height="{height - 2 * pad}" fill="none" stroke="#bbb"/>'
            f'<text x="{pad}" y="{height - 4}" font-size="10">{xmin:.4g}</text>'
            f'<text x="{width - pad - 30}" y="{height - 4}" font-size="10">'
            f'{xmax:.4g}</text>'
            f'<text x="2" y="{height - pad}" font-size="10">{ymin:.4g}</text>'
            f'<text x="2" y="{pad + 10}" font-size="10">{ymax:.4g}</text>')
    return frag, sx, sy


@_register
class ComponentText(Component):
    """Plain text block (ref ``text/ComponentText.java``)."""

    def __init__(self, text: str, *, size: int = 13):
        self.text = text
        self.size = int(size)

    def render(self) -> str:
        return (f'<p style="font-size:{self.size}px">'
                f'{_html.escape(self.text)}</p>')


@_register
class ComponentTable(Component):
    """Header + rows table (ref ``table/ComponentTable.java``)."""

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence[Any]],
                 *, title: str = ""):
        self.title = title
        self.header = list(header)
        self.rows = [[str(c) for c in r] for r in rows]

    def render(self) -> str:
        head = "".join(f"<th>{_html.escape(h)}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(c)}</td>" for c in r)
            + "</tr>" for r in self.rows)
        t = (f"<h3>{_html.escape(self.title)}</h3>" if self.title else "")
        return (f'{t}<table class="dl4j-table"><tr>{head}</tr>{body}</table>')


@_register
class ChartLine(Component):
    """Multi-series line chart (ref ``chart/ChartLine.java``)."""

    def __init__(self, title: str = "", *, width: int = 700,
                 height: int = 260):
        self.title = title
        self.width = int(width)
        self.height = int(height)
        self.series: List[Dict[str, Any]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: len(x) {len(x)} != "
                             f"len(y) {len(y)}")
        self.series.append({"name": name,
                            "x": [float(v) for v in x],
                            "y": [float(v) for v in y]})
        return self

    def render(self) -> str:
        w, h, pad = self.width, self.height, 36
        xs = [v for s in self.series for v in s["x"]]
        ys = [v for s in self.series for v in s["y"]]
        if not xs:
            return f"<h3>{_html.escape(self.title)}</h3><svg/>"
        frame, sx, sy = _axes(w, h, pad, min(xs), max(xs), min(ys), max(ys))
        paths, legend = [], []
        for i, s in enumerate(self.series):
            c = _PALETTE[i % len(_PALETTE)]
            d = "M" + " L".join(f"{sx(x):.1f},{sy(y):.1f}"
                                for x, y in zip(s["x"], s["y"]))
            paths.append(f'<path d="{d}" fill="none" stroke="{c}" '
                         f'stroke-width="1.5"/>')
            legend.append(f'<tspan fill="{c}">■ '
                          f'{_html.escape(s["name"])}</tspan> ')
        leg = (f'<text x="{pad}" y="14" font-size="11">'
               + "".join(legend) + "</text>")
        return (f"<h3>{_html.escape(self.title)}</h3>"
                f'<svg width="{w}" height="{h}">{frame}{leg}'
                f'{"".join(paths)}</svg>')


@_register
class ChartScatter(Component):
    """Scatter chart (ref ``chart/ChartScatter.java``)."""

    def __init__(self, title: str = "", *, width: int = 700,
                 height: int = 420, point_size: float = 2.5):
        self.title = title
        self.width = int(width)
        self.height = int(height)
        self.point_size = float(point_size)
        self.series: List[Dict[str, Any]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartScatter":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: len(x) != len(y)")
        self.series.append({"name": name,
                            "x": [float(v) for v in x],
                            "y": [float(v) for v in y]})
        return self

    def render(self) -> str:
        w, h, pad = self.width, self.height, 36
        xs = [v for s in self.series for v in s["x"]]
        ys = [v for s in self.series for v in s["y"]]
        if not xs:
            return f"<h3>{_html.escape(self.title)}</h3><svg/>"
        frame, sx, sy = _axes(w, h, pad, min(xs), max(xs), min(ys), max(ys))
        dots, legend = [], []
        for i, s in enumerate(self.series):
            c = _PALETTE[i % len(_PALETTE)]
            dots.extend(
                f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" '
                f'r="{self.point_size}" fill="{c}" fill-opacity="0.65"/>'
                for x, y in zip(s["x"], s["y"]))
            legend.append(f'<tspan fill="{c}">● '
                          f'{_html.escape(s["name"])}</tspan> ')
        leg = (f'<text x="{pad}" y="14" font-size="11">'
               + "".join(legend) + "</text>")
        return (f"<h3>{_html.escape(self.title)}</h3>"
                f'<svg width="{w}" height="{h}">{frame}{leg}'
                f'{"".join(dots)}</svg>')


@_register
class ChartHistogram(Component):
    """Histogram from bin edges + counts (ref ``chart/ChartHistogram.java``)."""

    def __init__(self, title: str = "", *, width: int = 700,
                 height: int = 220):
        self.title = title
        self.width = int(width)
        self.height = int(height)
        self.lower: List[float] = []
        self.upper: List[float] = []
        self.counts: List[float] = []

    def add_bin(self, lower: float, upper: float,
                count: float) -> "ChartHistogram":
        self.lower.append(float(lower))
        self.upper.append(float(upper))
        self.counts.append(float(count))
        return self

    def render(self) -> str:
        w, h, pad = self.width, self.height, 36
        if not self.counts:
            return f"<h3>{_html.escape(self.title)}</h3><svg/>"
        frame, sx, sy = _axes(w, h, pad, min(self.lower), max(self.upper),
                              0.0, max(self.counts) or 1.0)
        bars = []
        for lo, up, c in zip(self.lower, self.upper, self.counts):
            x0, x1 = sx(lo), sx(up)
            y = sy(c)
            bars.append(f'<rect x="{x0:.1f}" y="{y:.1f}" '
                        f'width="{max(x1 - x0 - 0.5, 0.5):.1f}" '
                        f'height="{h - pad - y:.1f}" fill="#4c78a8"/>')
        return (f"<h3>{_html.escape(self.title)}</h3>"
                f'<svg width="{w}" height="{h}">{frame}{"".join(bars)}</svg>')


@_register
class ChartTimeline(Component):
    """Swimlane timeline (ref ``chart/ChartTimeline.java``): named lanes,
    each holding [start, end, label] entries."""

    def __init__(self, title: str = "", *, width: int = 960,
                 lane_height: int = 28):
        self.title = title
        self.width = int(width)
        self.lane_height = int(lane_height)
        self.lanes: List[Dict[str, Any]] = []

    def add_lane(self, name: str,
                 entries: Sequence[Tuple[float, float, str]]
                 ) -> "ChartTimeline":
        self.lanes.append({
            "name": name,
            "entries": [[float(s), float(e), str(lbl)]
                        for s, e, lbl in entries]})
        return self

    def render(self) -> str:
        w, lane_h, label_w = self.width, self.lane_height, 160.0
        ends = [e for lane in self.lanes for _, e, _ in lane["entries"]]
        end = max(ends) if ends else 1.0
        scale = (w - label_w - 20) / max(end, 1e-9)
        rows = []
        for i, lane in enumerate(self.lanes):
            y = 30 + i * lane_h
            color = _PALETTE[i % len(_PALETTE)]
            rows.append(f'<text x="4" y="{y + 18}" font-size="12">'
                        f'{_html.escape(lane["name"])}</text>')
            for s, e, lbl in lane["entries"]:
                x = label_w + s * scale
                bw = max((e - s) * scale, 0.75)
                rows.append(
                    f'<rect x="{x:.2f}" y="{y + 4}" width="{bw:.2f}" '
                    f'height="{lane_h - 8}" fill="{color}">'
                    f'<title>{_html.escape(lbl)}</title></rect>')
        h = 40 + len(self.lanes) * lane_h
        return (f"<h3>{_html.escape(self.title)}</h3>"
                f'<svg width="{w}" height="{h}">{"".join(rows)}</svg>')


@_register
class ComponentDiv(Component):
    """Container of child components (ref ``component/ComponentDiv.java``)."""

    def __init__(self, *children: Component, style: str = ""):
        self.style = style
        self.children = [c.to_dict() for c in children]

    def render(self) -> str:
        inner = "".join(Component.from_dict(c).render()
                        for c in self.children)
        s = f' style="{_html.escape(self.style, quote=True)}"' \
            if self.style else ""
        return f"<div{s}>{inner}</div>"


class StaticPageUtil:
    """Render components into one standalone HTML page
    (ref ``standalone/StaticPageUtil.java``)."""

    _CSS = ("body{font-family:sans-serif;margin:20px;background:#fafafa}"
            ".dl4j-card{background:#fff;border:1px solid #ddd;"
            "border-radius:6px;padding:12px 16px;margin-bottom:14px;"
            "max-width:1000px}"
            "table.dl4j-table{border-collapse:collapse}"
            ".dl4j-table td,.dl4j-table th{border:1px solid #ccc;"
            "padding:4px 8px;font-size:13px}"
            "h2{font-size:1.25em}h3{font-size:1.0em;margin:4px 0}")

    @staticmethod
    def render_html(components: Sequence[Component],
                    title: str = "deeplearning4j_tpu report") -> str:
        cards = "".join(f'<div class="dl4j-card">{c.render()}</div>'
                        for c in components)
        return (f'<!DOCTYPE html><html><head><meta charset="utf-8">'
                f"<title>{_html.escape(title)}</title>"
                f"<style>{StaticPageUtil._CSS}</style></head><body>"
                f"<h2>{_html.escape(title)}</h2>{cards}</body></html>")

    @staticmethod
    def save_html(components: Sequence[Component], path: str,
                  title: str = "deeplearning4j_tpu report") -> None:
        with open(path, "w") as f:
            f.write(StaticPageUtil.render_html(components, title))
