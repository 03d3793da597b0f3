"""The port's ``eval/media.py`` against the JAX package's on the CPU: every
render string for string equal to JAX's on the same inputs, and to the
checked-in snapshots ``tests/data/golden_media/*.html`` after
``test_media_golden.py``'s normalisation of the tabs' random group token
(read here, never written); ``HVOSequence.to_html_plot``."""

import pathlib
import re
import types

import numpy as np
import pytest

from transformergrooveinfilling_tpu.eval import media as JM
from transformergrooveinfilling_tpu.hvo import sequence as JSeq
from transformergrooveinfilling_tpu_torch.eval import media as M
from transformergrooveinfilling_tpu_torch.hvo import sequence as Seq

GOLDEN_DIR = pathlib.Path(__file__).parent / "data" / "golden_media"
_GROUP_RE = re.compile(r'name="tabs-([0-9a-f]{8})"')


def _normalize(text: str) -> str:
    for i, token in enumerate(dict.fromkeys(_GROUP_RE.findall(text))):
        text = text.replace(token, f"GROUP{i}")
    return text


def _seq(seed: int, t: int = 32, voices: int = 9):
    """``test_media_golden.py``'s stand-in sequence."""
    rng = np.random.default_rng(seed)
    hits = (rng.random((t, voices)) < 0.3).astype(np.float32)
    vels = rng.random((t, voices)).astype(np.float32) * hits
    offs = (rng.random((t, voices)).astype(np.float32) - 0.5) * hits
    return types.SimpleNamespace(hvo=np.concatenate([hits, vels, offs], 1))


RENDERS = {
    "piano_roll": lambda m: m.piano_roll_html(_seq(0), title="golden roll"),
    "velocity_heatmap_h": lambda m: m.velocity_heatmap_html(
        {"funk": [_seq(1), _seq(2)], "rock": [_seq(3)], "empty": []}, "golden", horizontal=True),
    "velocity_heatmap_v": lambda m: m.velocity_heatmap_html(
        {"funk": [_seq(1), _seq(2)], "rock": [_seq(3)]}, "golden", horizontal=False),
    "tabs": lambda m: m.tabs_html(["<p>one</p>", "<p>two</p>"], ["A", "B"]),
    "histogram": lambda m: m._histogram_svg(np.random.default_rng(7).normal(size=200), "hist"),
    "histogram_empty": lambda m: m._histogram_svg([], "empty hist"),
    "feature_pdf": lambda m: m.feature_pdf_html(
        {"funk": [_seq(1), _seq(2)], "rock": [_seq(3)]}, "golden"),
    "document": lambda m: m.html_document("<p>body</p>", title="t"),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_equals_jax_and_the_golden(name):
    got = _normalize(RENDERS[name](M))
    assert got == _normalize(RENDERS[name](JM))
    assert got == (GOLDEN_DIR / f"{name}.html").read_text()


@pytest.mark.parametrize("seed", [0, 5])
def test_render_equals_jax_on_random_shapes(seed):
    rng = np.random.default_rng(seed)
    subsets = {tag: [_seq(int(s), t=48) for s in rng.integers(0, 1000, n)]
               for tag, n in (("jazz", 3), ("pop", 1), ("punk", 0))}
    for horizontal in (True, False):
        assert _normalize(M.velocity_heatmap_html(subsets, "x", horizontal)) == _normalize(
            JM.velocity_heatmap_html(subsets, "x", horizontal))
    assert _normalize(M.feature_pdf_html(subsets, "x")) == _normalize(
        JM.feature_pdf_html(subsets, "x"))
    values = rng.normal(size=50)
    values[3] = np.inf
    assert M._histogram_svg(values, "<t>", bins=7) == JM._histogram_svg(values, "<t>", bins=7)
    assert M.tabs_html([], []) == JM.tabs_html([], []) == ""


def test_to_html_plot_equals_jax():
    grid = _seq(11).hvo
    port, jax_seq = Seq.HVOSequence(hvo=grid.copy()), JSeq.HVOSequence(hvo=grid.copy())
    assert port.to_html_plot("roll") == jax_seq.to_html_plot("roll")
    assert port.to_html_plot() == M.piano_roll_html(port, title="piano_roll")
