"""Media rendering: piano rolls, velocity heatmaps, tabbed HTML, as the JAX
package's ``eval/media.py``, render for render the same strings.

The reference renders bokeh figures into wandb.Html; the JAX package emits
dependency-free, self-contained SVG-in-HTML instead (per-voice piano rolls
with velocity shading and offset-shifted x positions, per-style velocity
heatmaps, tabbed layout), and so does the port.
"""

from __future__ import annotations

import html as _html

import numpy as np

from ..hvo.mapping import VOICE_NAMES

_CELL_W, _CELL_H = 22, 18
_LABEL_W = 90


def _svg_header(width, height, title):
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="sans-serif" font-size="11">'
        f'<title>{_html.escape(title)}</title>'
    )


def piano_roll_html(seq, title: str = "piano_roll") -> str:
    """One sequence → SVG piano roll. x = grid step (+ offset shift),
    y = voice lane, opacity = velocity."""
    hvo = np.asarray(seq.hvo)
    t, n = hvo.shape[0], hvo.shape[1] // 3
    width = _LABEL_W + t * _CELL_W + 10
    height = (n + 1) * _CELL_H + 30
    parts = [_svg_header(width, height, title)]
    parts.append(
        f'<text x="4" y="14" font-weight="bold">{_html.escape(title)}</text>')
    for v in range(n):
        y = 24 + v * _CELL_H
        name = VOICE_NAMES[v] if v < len(VOICE_NAMES) else f"v{v}"
        parts.append(f'<text x="4" y="{y + 13}">{_html.escape(name)}</text>')
        parts.append(
            f'<line x1="{_LABEL_W}" y1="{y + _CELL_H}" x2="{width - 10}" '
            f'y2="{y + _CELL_H}" stroke="#ddd"/>')
        for step in range(t):
            if hvo[step, v] > 0:
                vel = float(np.clip(hvo[step, v + n], 0, 1))
                off = float(np.clip(hvo[step, v + 2 * n], -0.5, 0.5))
                x = _LABEL_W + (step + off) * _CELL_W
                parts.append(
                    f'<rect x="{x:.1f}" y="{y + 2}" width="{_CELL_W - 4}" '
                    f'height="{_CELL_H - 4}" rx="2" fill="#2166ac" '
                    f'fill-opacity="{0.25 + 0.75 * vel:.2f}"/>')
    # beat grid lines every 4 steps
    for step in range(0, t + 1, 4):
        x = _LABEL_W + step * _CELL_W
        parts.append(
            f'<line x1="{x}" y1="22" x2="{x}" y2="{height - 8}" '
            f'stroke="{"#999" if step % 16 == 0 else "#eee"}"/>')
    parts.append("</svg>")
    return "".join(parts)


def velocity_heatmap_html(subsets: dict, identifier: str,
                          horizontal: bool = True) -> str:
    """Per-style heatmap: mean velocity per (voice, step) across the subset
    (the reference's bokeh velocity heatmaps).

    ``horizontal``: time runs left→right with one row per voice (default);
    ``False`` transposes the grid (time top→bottom, one column per voice) —
    the orientation semantics this stack assigns to the evaluator's
    ``horizontal`` flag, which the reference stores but never reads."""
    sections = []
    titles = []  # parallel to sections: empty subsets are skipped, so the
    # tab labels must be collected alongside (not taken from sorted(subsets))
    for tag in sorted(subsets):
        samples = subsets[tag]
        if not samples:
            continue
        titles.append(tag)
        stack = np.stack([np.asarray(s.hvo) for s in samples])
        n = stack.shape[2] // 3
        vel = stack[:, :, n : 2 * n].mean(axis=0).T  # (V, T)
        t = vel.shape[1]
        if horizontal:
            width = _LABEL_W + t * _CELL_W + 10
            height = (n + 1) * _CELL_H + 30
        else:
            width = _LABEL_W + n * _CELL_W + 10
            height = (t + 1) * _CELL_H + 30
        parts = [_svg_header(width, height, f"{identifier}:{tag}")]
        parts.append(
            f'<text x="4" y="14" font-weight="bold">{_html.escape(tag)} '
            f'(n={len(samples)})</text>')
        vmax = max(vel.max(), 1e-6)
        if horizontal:
            for v in range(n):
                y = 24 + v * _CELL_H
                name = VOICE_NAMES[v] if v < len(VOICE_NAMES) else f"v{v}"
                parts.append(
                    f'<text x="4" y="{y + 13}">{_html.escape(name)}</text>')
                for step in range(t):
                    val = vel[v, step] / vmax
                    parts.append(
                        f'<rect x="{_LABEL_W + step * _CELL_W}" y="{y + 1}" '
                        f'width="{_CELL_W - 2}" height="{_CELL_H - 2}" '
                        f'fill="#b2182b" fill-opacity="{val:.2f}" '
                        f'stroke="#f0f0f0"/>')
        else:  # vertical: rows = time steps, columns = voices
            for step in range(t):
                y = 24 + step * _CELL_H
                parts.append(f'<text x="4" y="{y + 13}">t{step}</text>')
                for v in range(n):
                    val = vel[v, step] / vmax
                    parts.append(
                        f'<rect x="{_LABEL_W + v * _CELL_W}" y="{y + 1}" '
                        f'width="{_CELL_W - 2}" height="{_CELL_H - 2}" '
                        f'fill="#b2182b" fill-opacity="{val:.2f}" '
                        f'stroke="#f0f0f0"/>')
        parts.append("</svg>")
        sections.append("".join(parts))
    return tabs_html(sections, titles) if sections else ""


def tabs_html(contents: list, titles: list) -> str:
    """CSS-only tabbed layout (the reference's separate_figues_by_tabs)."""
    if not contents:
        return ""
    import uuid

    group = uuid.uuid4().hex[:8]
    parts = ['<div class="tgi-tabs" style="font-family:sans-serif">']
    for i, (content, title) in enumerate(zip(contents, titles)):
        checked = "checked" if i == 0 else ""
        tid = f"tab-{group}-{i}"
        parts.append(
            f'<input type="radio" name="tabs-{group}" id="{tid}" {checked} '
            f'style="display:none">'
            f'<label for="{tid}" style="padding:4px 10px;cursor:pointer;'
            f'display:inline-block;border:1px solid #ccc;border-bottom:none">'
            f'{_html.escape(str(title))}</label>')
    for i, content in enumerate(contents):
        tid = f"tab-{group}-{i}"
        parts.append(
            f'<div class="panel-{group}" id="panel-{tid}" '
            f'style="border:1px solid #ccc;padding:6px;'
            f'{"" if i == 0 else "display:none"}">{content}</div>')
    # pure-CSS tab switching
    css = "".join(
        f'#tab-{group}-{i}:checked ~ #panel-tab-{group}-{i}'
        f'{{display:block !important}}'
        f'#tab-{group}-{i}:not(:checked) ~ #panel-tab-{group}-{i}'
        f'{{display:none}}'
        for i in range(len(contents))
    )
    parts.append(f"<style>{css}</style></div>")
    return "".join(parts)


# Self-contained wheel-zoom + drag-pan for every inline SVG: the functional
# slice of the reference's interactive bokeh figures (zoom/pan on piano rolls
# and heatmaps) without the bokeh runtime. Applied at the document wrapper so
# the component renderers above stay byte-stable (tests/test_media_golden.py
# pins them).
_SVG_ZOOM_JS = """
<script>(function(){
for (const svg of document.querySelectorAll('svg')) {
  if (!svg.getAttribute('viewBox')) {
    const w = parseFloat(svg.getAttribute('width')) || svg.clientWidth;
    const h = parseFloat(svg.getAttribute('height')) || svg.clientHeight;
    if (!w || !h) continue;
    svg.setAttribute('viewBox', '0 0 ' + w + ' ' + h);
  }
  svg.style.cursor = 'grab';
  let drag = null;
  const vb = () => svg.getAttribute('viewBox').split(/\\s+/).map(Number);
  svg.addEventListener('wheel', (e) => {
    e.preventDefault();
    const [x, y, w, h] = vb();
    const k = e.deltaY < 0 ? 0.85 : 1 / 0.85;
    const r = svg.getBoundingClientRect();
    const px = x + (e.clientX - r.left) / r.width * w;
    const py = y + (e.clientY - r.top) / r.height * h;
    svg.setAttribute('viewBox', (px - (px - x) * k) + ' ' +
      (py - (py - y) * k) + ' ' + (w * k) + ' ' + (h * k));
  }, {passive: false});
  svg.addEventListener('pointerdown', (e) => {
    drag = {x: e.clientX, y: e.clientY, vb: vb()};
    svg.setPointerCapture(e.pointerId);
    svg.style.cursor = 'grabbing';
  });
  svg.addEventListener('pointermove', (e) => {
    if (!drag) return;
    const [x, y, w, h] = drag.vb;
    const r = svg.getBoundingClientRect();
    svg.setAttribute('viewBox',
      (x - (e.clientX - drag.x) / r.width * w) + ' ' +
      (y - (e.clientY - drag.y) / r.height * h) + ' ' + w + ' ' + h);
  });
  const up = () => { drag = null; svg.style.cursor = 'grab'; };
  svg.addEventListener('pointerup', up);
  svg.addEventListener('pointercancel', up);
  svg.addEventListener('dblclick', () => {
    const w = parseFloat(svg.getAttribute('width')) || svg.clientWidth;
    const h = parseFloat(svg.getAttribute('height')) || svg.clientHeight;
    svg.setAttribute('viewBox', '0 0 ' + w + ' ' + h);
  });
}
})();</script>"""


def html_document(body: str, title: str = "report") -> str:
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title></head>"
            f"<body>{body}{_SVG_ZOOM_JS}</body></html>")


def _histogram_svg(values, title: str, bins: int = 20,
                   width: int = 420, height: int = 160) -> str:
    """Dependency-free histogram (the reference's bokeh feature PDFs)."""
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    parts = [_svg_header(width, height, title),
             f'<text x="4" y="14">{_html.escape(title)}</text>']
    if values.size:
        counts, edges = np.histogram(values, bins=bins)
        peak = max(counts.max(), 1)
        plot_w, plot_h, x0, y0 = width - 20, height - 40, 10, 20
        bar_w = plot_w / bins
        for i, c in enumerate(counts):
            h = plot_h * c / peak
            parts.append(
                f'<rect x="{x0 + i * bar_w:.1f}" y="{y0 + plot_h - h:.1f}" '
                f'width="{bar_w - 1:.1f}" height="{h:.1f}" fill="#2166ac" '
                f'fill-opacity="0.8"/>')
        parts.append(
            f'<text x="{x0}" y="{height - 4}" font-size="9">'
            f'{edges[0]:.2f}</text>'
            f'<text x="{width - 50}" y="{height - 4}" font-size="9">'
            f'{edges[-1]:.2f}</text>')
    parts.append("</svg>")
    return "".join(parts)


def feature_pdf_html(subsets: dict, identifier: str) -> str:
    """Per-family tabs of per-feature value histograms over all samples
    (reference "global_feature_pdfs" media)."""
    from .features import ALL_FAMILIES

    samples = [s for sub in subsets.values() for s in sub]
    if not samples:
        return ""
    stack = np.stack([np.asarray(s.hvo) for s in samples])
    family_tabs, family_names = [], []
    for family, fn in ALL_FAMILIES.items():
        feats = fn(stack)
        plots = "".join(
            _histogram_svg(vec, f"{family}::{name}")
            for name, vec in feats.items())
        family_tabs.append(f"<div>{plots}</div>")
        family_names.append(family)
    return tabs_html(family_tabs, family_names)
