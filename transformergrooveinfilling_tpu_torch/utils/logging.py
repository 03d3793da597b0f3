"""Experiment tracking with the wandb call surface, as the JAX package's
``utils/logging.py``.

The same surface (``init/config/log/log_record/save/watch/finish``,
``run.dir``/``run.id``, ``Html``/``Audio``/``Histogram``) backed by a local
run directory: ``metrics.jsonl`` (one committed record per line), media files
under ``media/``, ``config.json`` and ``curves.svg`` at ``finish``, so a run
leaves the same files in either package. Unlike the JAX package, which goes
to the real wandb service whenever the package imports and ``WANDB_MODE`` is
not ``offline``/``disabled``, the port goes there only when asked for with
``WANDB_MODE=online`` (wandb is imported then): a machine that has wandb
installed but no network, as the card's has, keeps its runs local. Without a
run, ``log`` does nothing.
"""

from __future__ import annotations

import html
import json
import os
import threading
import time

_real_wandb = None  # the wandb module, imported when WANDB_MODE=online asks for it


class _Config(dict):
    """Attribute-style config mirroring ``wandb.config``."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def update(self, d, allow_val_change: bool = True):  # wandb signature
        dict.update(self, d)


class Run:
    def __init__(self, run_dir: str, run_id: str, project: str, cfg: _Config):
        self.dir = run_dir
        self.id = run_id
        self.name = run_id
        self.project = project
        self.config = cfg
        self._metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._pending: dict = {}
        # the async media worker (train/driver.py) logs from its own thread
        # while the main loop logs scalars — _pending and the JSONL append
        # must not interleave
        self._log_lock = threading.Lock()

    def log(self, data: dict, commit: bool = True):
        # media file writes (wav/html) happen outside the lock — only the
        # pending-merge and the JSONL append need atomicity
        persisted = self._persist(data, prefix="")
        with self._log_lock:
            self._pending.update(persisted)
            if commit:
                self._pending["_timestamp"] = time.time()
                with open(self._metrics_path, "a") as f:
                    f.write(json.dumps(self._pending) + "\n")
                self._pending = {}

    def log_record(self, data: dict):
        """Write ``data`` as its OWN committed JSONL record, without touching
        the shared pending dict. Background threads (the async media worker)
        must use this: a worker-side ``log(commit=True)`` would sweep the
        training thread's uncommitted scalars into the worker's record —
        misattributing one epoch's metrics to another's media line."""
        persisted = self._persist(data, prefix="")
        persisted["_timestamp"] = time.time()
        with self._log_lock:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(persisted) + "\n")

    def _persist(self, data: dict, prefix: str) -> dict:
        """JSON-serializable view of a log dict; media objects (Html/Audio)
        are written under <run.dir>/media/ and replaced by their paths."""
        out = {}
        for k, v in data.items():
            key = f"{prefix}{k}"
            if isinstance(v, (int, float, str, bool)) or v is None:
                out[key] = v
            elif hasattr(v, "item") and getattr(v, "size", 2) == 1:
                out[key] = v.item()
            elif isinstance(v, Html):
                out[key] = self._write_media(key, "html", v.html.encode())
            elif isinstance(v, Audio):
                out[key] = self._write_audio(key, v)
            elif isinstance(v, Histogram):
                # wandb's own JSONL encoding for histograms
                out[key] = {"_type": "histogram",
                            "values": [int(c) for c in v.counts],
                            "bins": [float(b) for b in v.bins]}
            elif isinstance(v, (list, tuple)) and v and isinstance(
                    v[0], (Html, Audio)):
                out[key] = [
                    self._write_media(f"{key}_{i}", "html", m.html.encode())
                    if isinstance(m, Html) else self._write_audio(
                        f"{key}_{i}", m)
                    for i, m in enumerate(v)
                ]
            elif isinstance(v, dict):
                out[key] = self._persist(v, prefix=f"{key}.")
            else:
                out[key] = f"<{type(v).__name__}>"
        return out

    def _write_media(self, key: str, ext: str, payload: bytes) -> str:
        media_dir = os.path.join(self.dir, "media")
        os.makedirs(media_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in key)
        path = os.path.join(media_dir, f"{safe}.{ext}")
        with open(path, "wb") as f:
            f.write(payload)
        return os.path.relpath(path, self.dir)

    def _write_audio(self, key: str, audio: "Audio") -> str:
        media_dir = os.path.join(self.dir, "media")
        os.makedirs(media_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in (audio.caption or key))
        if safe.endswith(".wav"):  # captions often carry the extension already
            safe = safe[:-4]
        path = os.path.join(media_dir, f"{safe}.wav")
        from ..audio.synth import write_wav

        write_wav(path, audio.data, audio.sample_rate)
        return os.path.relpath(path, self.dir)

    def finish(self):
        if self._pending:
            self.log({}, commit=True)
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(dict(self.config), f, indent=2, default=str)
        self._render_curves()

    def _render_curves(self):
        """Render loss/accuracy curves from metrics.jsonl to an SVG next to it."""
        try:
            series: dict[str, list] = {}
            with open(self._metrics_path) as f:
                for line in f:
                    rec = json.loads(line)
                    ep = rec.get("epoch")
                    if ep is None:
                        continue
                    for key in ("loss", "validation_loss", "hit_accuracy"):
                        if key in rec:
                            series.setdefault(key, []).append((ep, rec[key]))
            if not series.get("loss"):
                return
            w, h, pad = 640, 240, 40
            parts = [_svg_header(w, h, "training curves")]
            all_pts = [p for pts in series.values() for p in pts]
            xs = [p[0] for p in all_pts]
            ys = [p[1] for p in series.get("loss", [])] + [
                p[1] for p in series.get("validation_loss", [])]
            x0, x1 = min(xs), max(max(xs), min(xs) + 1)
            y0, y1 = min(ys), max(max(ys), min(ys) + 1e-9)
            colors = {"loss": "#2166ac", "validation_loss": "#b2182b",
                      "hit_accuracy": "#1a9850"}
            for name, pts in series.items():
                pts = sorted(pts)
                lo, hi = (0.0, 1.0) if name == "hit_accuracy" else (y0, y1)
                path = " ".join(
                    f"{'M' if i == 0 else 'L'}"
                    f"{pad + (e - x0) / (x1 - x0) * (w - 2 * pad):.1f},"
                    f"{h - pad - (v - lo) / max(hi - lo, 1e-9) * (h - 2 * pad):.1f}"
                    for i, (e, v) in enumerate(pts))
                parts.append(f'<path d="{path}" fill="none" '
                             f'stroke="{colors.get(name, "#555")}" '
                             f'stroke-width="1.5"/>')
            legend = " | ".join(f"{n}" for n in series)
            parts.append(f'<text x="{pad}" y="16">{legend} '
                         f'(loss {y0:.3f}–{y1:.3f}, epochs {x0}–{x1})</text>')
            parts.append(f'<line x1="{pad}" y1="{h-pad}" x2="{w-pad}" '
                         f'y2="{h-pad}" stroke="#999"/>')
            parts.append("</svg>")
            with open(os.path.join(self.dir, "curves.svg"), "w") as f:
                f.write("".join(parts))
        except Exception:
            pass  # observability extra; never fail a run over it


def _svg_header(width, height, title):
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" font-family="sans-serif" font-size="11">'
            f'<title>{html.escape(title)}</title>')


# module-level singleton mirroring the wandb API
run: Run | None = None
config = _Config()


def _wandb_online() -> bool:
    """Whether calls go to the real wandb: only with ``WANDB_MODE=online``
    and the package importable."""
    global _real_wandb
    if os.environ.get("WANDB_MODE") != "online":
        return False
    if _real_wandb is None:
        try:
            import wandb
        except ImportError:
            return False
        _real_wandb = wandb
    return True


_init_count = 0  # run_id uniqueness within a process (sweep loops re-init)


def init(config: dict | None = None, project: str = "run", job_type: str = "train",
         notes: str | None = None, tags=None, run_dir: str | None = None, **kw):
    """wandb.init-compatible; returns the active Run (real or local)."""
    global run, _init_count
    if _wandb_online():  # routed through the fake-wandb contract tests
        real_run = _real_wandb.init(config=config, project=project,
                                    job_type=job_type, notes=notes, tags=tags,
                                    **kw)
        # the config round-trip (train.py reads xlog.config back, datasets
        # self-register into it) must reach the real wandb run too
        globals()["config"] = _real_wandb.config
        return real_run
    _init_count += 1
    run_id = (time.strftime("%Y%m%d_%H%M%S")
              + f"_{os.getpid()%10000:04d}_{_init_count}")
    base = run_dir or os.path.join("runs", project)
    # absolute: the run must stay writable if the caller later chdirs
    rdir = os.path.abspath(os.path.join(base, run_id))
    os.makedirs(rdir, exist_ok=True)
    # ONE shared config object: the module-level `config` IS the run's config,
    # so `xlog.config.update(...)` (datasets.py self-registration) lands in
    # the config.json the run persists at finish()
    cfg = globals().get("config")
    if not isinstance(cfg, _Config):
        cfg = _Config()
        globals()["config"] = cfg
    cfg.clear()
    cfg.update(config or {})
    run = Run(rdir, run_id, project, cfg)
    return run


def _to_real_media(v):
    """Local Html/Audio/Histogram stubs → real wandb media (recursively)."""
    if isinstance(v, Html):
        return _real_wandb.Html(v.html)
    if isinstance(v, Audio):
        return _real_wandb.Audio(v.data, sample_rate=v.sample_rate,
                                 caption=getattr(v, "caption", None))
    if isinstance(v, Histogram):
        return _real_wandb.Histogram(np_histogram=(list(v.counts),
                                                   list(v.bins)))
    if isinstance(v, dict):
        return {k: _to_real_media(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_real_media(x) for x in v)
    return v


def log(data: dict, commit: bool = True):
    if _wandb_online():  # routed through the fake-wandb contract tests
        return _real_wandb.log(_to_real_media(data), commit=commit)
    if run is not None:
        run.log(data, commit=commit)


def log_record(data: dict):
    """One self-contained committed record (see ``Run.log_record``). Online
    wandb has no pending-isolation concept — deferred logging is disabled
    there anyway (eval/evaluator.py::log_eval) — so this forwards to a
    plain committed log."""
    if _wandb_online():  # routed through the fake-wandb contract tests
        return _real_wandb.log(_to_real_media(data), commit=True)
    if run is not None:
        run.log_record(data)


def save(path: str, base_path: str | None = None):
    """wandb.save: files under run.dir are already persisted locally — no-op."""
    if _wandb_online():  # routed through the fake-wandb contract tests
        return _real_wandb.save(path, base_path=base_path)


def watch(model, log_freq: int = 1000):
    """The reference's ``wandb.watch(model, log_freq=1000)`` contract. The
    per-tensor gradient/parameter histograms come from the train driver
    (``train/loop.py::make_watch_fn``, ``run_training``'s ``watch_log_freq``),
    logged under wandb.watch's key names (``gradients/<path>``,
    ``parameters/<path>``, the flax paths) as :class:`Histogram` records.
    This function only forwards the registration to real wandb when online;
    the histogram cadence is the driver's."""
    if _wandb_online():  # routed through the fake-wandb contract tests
        try:
            _real_wandb.watch(model, log_freq=log_freq)
        except Exception:
            pass


def finish():
    global run
    if _wandb_online():  # routed through the fake-wandb contract tests
        return _real_wandb.finish()
    if run is not None:
        run.finish()
        run = None


def ensure_configured() -> bool:
    """True when a run is active (reference dataset.py:145 gate)."""
    if _wandb_online():  # routed through the fake-wandb contract tests
        return True
    return run is not None


class Html:
    """Minimal stand-in for wandb.Html: wraps an HTML string; the local sink
    writes it next to the metrics."""

    def __init__(self, html: str):
        self.html = html


class Audio:
    def __init__(self, data, caption: str = "", sample_rate: int = 44100):
        self.data = data
        self.caption = caption
        self.sample_rate = sample_rate


class Histogram:
    """Minimal stand-in for wandb.Histogram: pre-binned counts + bin edges
    (len(bins) == len(counts) + 1), persisted in wandb's histogram JSON."""

    def __init__(self, counts, bins):
        self.counts = counts
        self.bins = bins
