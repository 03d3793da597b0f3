"""Low-latency infill serving on one CUDA device.

Counterpart of ``transformergrooveinfilling_tpu/serve.py``. Design:

- requests route to the smallest batch-size bucket ≥ n (or chunk over the
  largest) and are zero-padded, so the model only ever sees the bucket shapes;
  every bucket is run once at start-up, which also builds the CUDA kernel.
- a request's chunks go to the device as ONE host→device copy, and the stacked
  ``(B, T, 27)`` h/v/o result comes back as ONE device→host copy.
- on a CUDA device every layer's attention runs the hand-written fused kernel
  (``ops/attention.py::fused_mha``); ``use_kernel=False`` runs its plain
  PyTorch version instead (for comparison). There is no CPU fallback:
  ``device="cuda"`` without CUDA raises.
- an encoder-decoder config (``num_decoder_layers > 0``) is served like an
  encoder-only one: the forward passes no target, so the decoder reads zeros
  (as the JAX server does), and each forward chunk launches the kernel once
  per encoder layer, per causal decoder self-attention and per decoder
  cross-attention (18 times at 6 + 6 layers).
- a partial HVO grid sent to an audio-modality model (``hvo_input``) goes
  through the synth + MSO front end on the server's device: on a CUDA device
  the hand-written synthesizer and band-energy kernels
  (``ops/device_synth.py``, ``ops/band_energies.py``), never leaving the card
  between the grid and the model's input.

- ``infill_from_hvo(..., sf_path=kit)`` renders through a SoundFont kit: its
  table is packed once per set of kits and kept on the device, and each
  request's events pick their rows through the kit's velocity layers.

``InfillServer.serve_http`` exposes a stdlib ThreadingHTTPServer JSON endpoint
(POST /infill with {"input": [[...]]} or {"hvo_input": [[...]], "qpm": 120};
GET /healthz). ``"format": "midi"`` adds the first item of the reply as a
standard MIDI file (``midi_base64``), as the JAX server does. A body naming an
``sf_path`` is answered 400: the server does not open a path a client names
(the JAX server ignores the field).

The CLI serves a native ``.ckpt`` (either package's; the architecture comes
from the file), a directory (newest epoch wins, a ``.Model`` as fallback), a
reference ``.Model`` (with the architecture flags), or an ``export.py``
artifact (``--artifact``; either package's): :meth:`InfillServer.from_exported`
rebuilds the model from the artifact's config and parameters, and its buckets
and threshold apply unless ``--batch-sizes`` / ``--thres`` are given.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import queue
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np
import torch

from . import require_device
from .models import build_model
from .models.transformer import GrooveTransformerConfig


@dataclasses.dataclass
class ServeStats:
    """Latency accounting shared across ThreadingHTTPServer handler threads;
    all access is lock-guarded (record's halving ``del`` would otherwise race
    /healthz percentile reads)."""

    count: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def record(self, ms: float):
        with self._lock:
            self.count += 1
            self.latencies_ms.append(ms)
            if len(self.latencies_ms) > 10000:
                del self.latencies_ms[: len(self.latencies_ms) // 2]

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self.latencies_ms:
                return float("nan")
            return float(np.percentile(self.latencies_ms, p))


class _Coalescer:
    """Dynamic request batching: concurrent callers' inputs merge into one
    batched forward per dispatch window, so under N concurrent clients the
    device sees ~N-sized batches instead of N serialized size-1 calls."""

    def __init__(self, server: "InfillServer", max_wait_ms: float = 2.0):
        self._server = server
        self._queue: queue.Queue = queue.Queue()
        self._max_wait = max_wait_ms / 1000.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="infill-coalescer")
        self._thread.start()

    def submit(self, x: np.ndarray) -> np.ndarray:
        done = threading.Event()
        holder: dict = {}
        self._queue.put((x, done, holder))
        done.wait()
        if "err" in holder:
            raise holder["err"]
        return holder["out"]

    def _loop(self):
        while True:
            first = self._queue.get()
            batch = [first]
            count = first[0].shape[0]
            cap = self._server.batch_sizes[-1]
            deadline = time.perf_counter() + self._max_wait
            while count < cap:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(nxt)
                count += nxt[0].shape[0]
            try:
                out = self._server._predict_batched(
                    np.concatenate([b[0] for b in batch], axis=0))
                i = 0
                for x, done, holder in batch:
                    holder["out"] = out[i : i + x.shape[0]]
                    i += x.shape[0]
                    done.set()
            except Exception as e:  # propagate to every still-waiting caller
                for _x, done, holder in batch:
                    # never clobber a result already handed out
                    if "out" not in holder:
                        holder["err"] = e
                    done.set()


class InfillServer:
    def __init__(self, state_dict: dict, config: GrooveTransformerConfig,
                 batch_sizes: Sequence[int] = (1, 8, 32),
                 use_thres: bool = True, thres: float = 0.5,
                 use_kernel: bool | None = None,
                 coalesce: bool = False, coalesce_wait_ms: float = 2.0,
                 device: str | torch.device = "cuda"):
        """``state_dict``: the model's weights (reference key names, as
        ``models.torch_compat`` produces them)."""
        self.device = require_device(device, "InfillServer")
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        if use_kernel and self.device.type != "cuda":
            raise ValueError(
                f"use_kernel=True needs a CUDA device, got {self.device}: the "
                "fused attention kernel runs only on the card")
        self.config = dataclasses.replace(config, use_fused_attention=use_kernel)
        self.model = build_model(self.config, self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.batch_sizes = sorted(batch_sizes)
        self.use_thres = use_thres
        self.thres = thres
        self.stats = ServeStats()
        # warm every bucket (the first forward on the card builds the kernel)
        shape = (self.config.max_len, self.config.embedding_size_src)
        for b in self.batch_sizes:
            self._forward(torch.zeros((b,) + shape, device=self.device))
        if self.device.type == "cuda":
            if self.config.embedding_size_src != self.config.embedding_size_tgt:
                # an audio model on the card: build the kit, its table and the
                # front end's kernels now, not inside the first hvo_input request
                self._front_end(np.zeros((1, self.config.max_len,
                                          self.config.embedding_size_tgt), np.float32), 120.0)
            torch.cuda.synchronize(self.device)
        self._coalescer = (_Coalescer(self, coalesce_wait_ms) if coalesce
                           else None)

    @classmethod
    def from_exported(cls, path: str, **kwargs) -> "InfillServer":
        """A full server (coalescing, HTTP, stats) from an artifact written by
        ``export.export_infill`` (either package's): the model is rebuilt
        from the artifact's config and parameters, on the card with the
        attention kernel; ``batch_sizes``, ``use_thres`` and ``thres``
        default to the artifact's. ``export.load_infill`` runs the
        artifact's own programs instead, without the model code."""
        from .export import load_infill
        from .train.checkpoint import config_from_json_dict

        loaded = load_infill(path, device=kwargs.get("device", "cuda"))
        config = config_from_json_dict(loaded.config_dict)
        kwargs.setdefault("batch_sizes", tuple(loaded.batch_sizes))
        kwargs.setdefault("use_thres", loaded.meta["use_thres"])
        kwargs.setdefault("thres", loaded.meta["thres"])
        return cls(loaded.params, config, **kwargs)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h_logits, v, o = self.model(x)
        h = torch.sigmoid(h_logits)
        if self.use_thres:
            h = (h > self.thres).to(torch.float32)
        return torch.cat([h, v, o], dim=-1)

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def _predict_batched(self, x: np.ndarray) -> np.ndarray:
        """Validated ``(N, T, E)`` → ``(N, T, 27)``: chunks of the largest
        bucket, then one padded chunk of the smallest bucket that holds the
        rest."""
        n = x.shape[0]
        chunks = []  # (start, bucket)
        i = 0
        while i < n:
            b = self._bucket(n - i)
            chunks.append((i, b))
            i += b
        if i > n:  # only the last chunk is short: pad its tail with zeros
            x = np.concatenate([x, np.zeros((i - n,) + x.shape[1:], x.dtype)])
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)  # one copy in
        outs = [self._forward(xd[s : s + b]) for s, b in chunks]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        return out.cpu().numpy()[:n]  # one copy out

    def infill(self, inputs) -> np.ndarray:
        """``(N, T, E_src)`` (or a single ``(T, E_src)``) → ``(N, T, 27)``."""
        t0 = time.perf_counter()
        x = np.asarray(inputs, np.float32)
        single = x.ndim == 2
        if single:
            x = x[None]
        expected = (self.config.max_len, self.config.embedding_size_src)
        if x.ndim != 3 or x.shape[1:] != expected:
            raise ValueError(
                f"input must be (T={expected[0]}, E={expected[1]}) or "
                f"(N, {expected[0]}, {expected[1]}); got {np.asarray(inputs).shape}")
        if self._coalescer is not None:
            out = self._coalescer.submit(x)
        else:
            out = self._predict_batched(x)
        self.stats.record((time.perf_counter() - t0) * 1000.0)
        return out[0] if single else out

    def _front_end(self, grids: np.ndarray, qpm: float, sf_path=None) -> np.ndarray:
        """``(N, T, 27)`` partial grids → ``(N, T, 16)`` MSO of their renders
        at ``qpm`` with the kit at ``sf_path`` (None: the procedural kit), on
        the server's device."""
        from .ops.mso import MSOParams, mso_batch_from_hvo

        n = grids.shape[0]
        return mso_batch_from_hvo(grids, [sf_path] * n, np.full((n,), qpm),
                                  params=MSOParams(), device=self.device)

    def infill_from_hvo(self, partial_hvo, qpm: float = 120.0, sf_path=None) -> np.ndarray:
        """Infill from a partial HVO grid ``(T, 27)`` or ``(N, T, 27)``.

        Symbolic models take the grid as their input. Audio-modality models
        (16-wide input) get the full direct-audio front end on the server's
        device: synthesize the partial loop at ``qpm`` through the ``.sf2``
        kit at ``sf_path`` (None: the procedural kit) and compute its MSO,
        then infill."""
        x = np.asarray(partial_hvo, np.float32)
        width = self.config.embedding_size_tgt
        if x.ndim not in (2, 3) or x.shape[-1] != width:
            raise ValueError(
                f"hvo_input must be a (T, {width}) or (N, T, {width}) HVO grid; "
                f"got {x.shape}")
        if self.config.embedding_size_src == width:
            return self.infill(x)  # symbolic model: the grid is the input
        single = x.ndim == 2
        out = self.infill(self._front_end(x[None] if single else x, float(qpm), sf_path))
        return out[0] if single else out

    # -- HTTP endpoint ---------------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 8327,
                   block: bool = True):
        server_self = self

        class Handler(_JSONHandler):
            def do_GET(self):
                if self.path != "/healthz":
                    return self._not_found()
                p50 = server_self.stats.percentile(50)
                p99 = server_self.stats.percentile(99)
                self._reply(200, {
                    "ok": True,
                    "count": server_self.stats.count,
                    # null, not NaN: bare NaN is invalid strict JSON
                    "p50_ms": p50 if np.isfinite(p50) else None,
                    "p99_ms": p99 if np.isfinite(p99) else None,
                })

            def do_POST(self):
                if self.path != "/infill":
                    return self._not_found()
                try:
                    payload = self._read_json()
                    if "sf_path" in payload:
                        raise ValueError(
                            '"sf_path" is not accepted over HTTP: the server opens no '
                            'path a client names (hvo_input renders with the procedural kit)')
                    if "hvo_input" in payload:
                        # partial HVO grid: the server runs the synth + MSO
                        # front end for audio models
                        out = server_self.infill_from_hvo(
                            payload["hvo_input"], qpm=float(payload.get("qpm", 120.0)))
                    elif "input" in payload:
                        out = server_self.infill(payload["input"])
                    else:
                        raise ValueError(
                            'request body needs an "input" (model-space) or '
                            '"hvo_input" (partial HVO grid) field')
                    reply = {"hvo": out.tolist()}
                    if payload.get("format") == "midi":
                        reply["midi_base64"] = midi_reply(
                            out, float(payload.get("qpm", 120.0)))
                    self._reply(200, reply)
                except Exception as e:  # bad input → 400 with a named reason
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        return _start_http(Handler, host, port, block)


def midi_reply(out: np.ndarray, qpm: float) -> str:
    """The ``"format": "midi"`` field: the first item of a reply (``(T, 27)``
    or ``(N, T, 27)``) as a base64 standard MIDI file at ``qpm``."""
    from .data.midi import hvo_to_midi
    from .hvo.sequence import HVOSequence, Tempo

    seq = HVOSequence(hvo=out if out.ndim == 2 else out[0], tempos=[Tempo(qpm=qpm)])
    return base64.b64encode(hvo_to_midi(seq)).decode()


class _JSONHandler(BaseHTTPRequestHandler):
    """Quiet handler with JSON replies, shared by both servers' endpoints."""

    def log_message(self, *a):
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _not_found(self):
        self.send_response(404)
        self.end_headers()

    def _read_json(self) -> dict:
        payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload


def _start_http(handler, host: str, port: int, block: bool):
    class Server(ThreadingHTTPServer):
        # burst-tolerant accept backlog: coalescing releases whole batches of
        # clients at once, which reconnect simultaneously — the stdlib
        # default backlog of 5 resets the overflow
        request_queue_size = 128
        daemon_threads = True

    httpd = Server((host, port), handler)
    if block:
        httpd.serve_forever()
        return httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def latency_benchmark(server: InfillServer, n_requests: int = 100,
                      batch: int = 1, seed: int = 0,
                      url: str | None = None, hvo_input: bool = False,
                      qpm: float = 120.0) -> dict:
    """p50/p99 request latency through the full infill path: in-process, or,
    with ``url`` (``http://host:port/infill`` of ``server.serve_http``), as
    JSON over HTTP. ``hvo_input=True`` sends partial HVO grids (30 % hits) at
    ``qpm`` instead of model-space inputs, so an audio model's requests
    include the synth + MSO front end."""
    rng = np.random.default_rng(seed)
    shape = (n_requests + 1, batch, server.config.max_len)
    if hvo_input:
        h = (rng.random(shape + (server.config.embedding_size_tgt // 3,)) < 0.3)
        xs = np.concatenate([h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)],
                            axis=-1).astype(np.float32)
        field, extra = "hvo_input", {"qpm": qpm}
    else:
        xs = rng.standard_normal(shape + (server.config.embedding_size_src,)).astype(np.float32)
        field, extra = "input", {}

    def one(x):
        if url is None:
            return server.infill_from_hvo(x, qpm=qpm) if hvo_input else server.infill(x)
        req = urllib.request.Request(
            url, data=json.dumps({field: x.tolist(), **extra}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())["hvo"]

    one(xs[-1])  # prime
    lat = []
    for i in range(n_requests):
        t0 = time.perf_counter()
        one(xs[i])
        lat.append((time.perf_counter() - t0) * 1000.0)
    return {
        "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(np.mean(lat)),
    }


class MultiTaskServer:
    """Serve every infilling subtask from one process: routes by experiment
    name to per-task servers behind one HTTP endpoint (POST /infill with
    {"experiment": ..., "input": ...}; GET /healthz aggregates per-task
    latency stats). Each task's weights stay resident on the device."""

    def __init__(self, bundles: dict, batch_sizes=(1, 8, 32),
                 use_kernel: bool | None = None, coalesce: bool = False,
                 coalesce_wait_ms: float = 2.0,
                 device: str | torch.device = "cuda"):
        """``bundles``: {experiment_name: (state_dict, GrooveTransformerConfig)}."""
        self.servers = {
            name: InfillServer(state_dict, config, batch_sizes=batch_sizes,
                               use_kernel=use_kernel, coalesce=coalesce,
                               coalesce_wait_ms=coalesce_wait_ms, device=device)
            for name, (state_dict, config) in bundles.items()
        }

    def infill(self, experiment: str, inputs):
        if experiment not in self.servers:
            raise KeyError(
                f"unknown experiment {experiment!r}; serving "
                f"{sorted(self.servers)}")
        return self.servers[experiment].infill(inputs)

    def stats(self) -> dict:
        out = {}
        for name, srv in self.servers.items():
            p50, p99 = srv.stats.percentile(50), srv.stats.percentile(99)
            out[name] = {"count": srv.stats.count,
                         "p50_ms": p50 if np.isfinite(p50) else None,
                         "p99_ms": p99 if np.isfinite(p99) else None}
        return out

    def serve_http(self, host: str = "127.0.0.1", port: int = 8328,
                   block: bool = True):
        outer = self

        class Handler(_JSONHandler):
            def do_GET(self):
                if self.path != "/healthz":
                    return self._not_found()
                self._reply(200, {"ok": True, "tasks": outer.stats()})

            def do_POST(self):
                if self.path != "/infill":
                    return self._not_found()
                try:
                    payload = self._read_json()
                    for field in ("experiment", "input"):
                        if field not in payload:
                            raise ValueError(
                                f'request body needs an "{field}" field')
                    out = outer.infill(payload["experiment"], payload["input"])
                    self._reply(200, {"hvo": out.tolist()})
                except Exception as e:  # bad input → 400 with a named reason
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        return _start_http(Handler, host, port, block)


def load_checkpoint(path: str, legacy_config: GrooveTransformerConfig):
    """A native ``.ckpt``, a reference ``.Model`` or a directory (newest
    epoch wins; a ``.Model`` when no ``.ckpt`` is there) → ``(state_dict,
    config, epoch, loss)``. A ``.ckpt`` carries its config; a ``.Model``
    carries no architecture, so ``legacy_config`` gives it."""
    from .train.checkpoint import load_params_and_config

    return load_params_and_config(path, legacy_config=legacy_config)


def main(argv=None, block: bool = True):
    """Serve a trained checkpoint over HTTP.

    Usage: python -m transformergrooveinfilling_tpu_torch.serve \\
               (--ckpt <file-or-dir> | --artifact <m.tgix>) [--port 8327]
               [--batch-sizes 1 8 32] [--thres 0.5]
    A native ``.ckpt`` carries its model config; legacy ``.Model`` files
    carry none: pass the architecture flags. An artifact carries its config,
    buckets and threshold; a flag given overrides them.
    Returns the HTTP server (with ``block=False`` it serves on a thread).
    """
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", help=".ckpt/.Model file, or a directory (newest epoch wins)")
    p.add_argument("--artifact",
                   help="serve an export.py artifact (.tgix) instead of a checkpoint: "
                        "config, params, buckets and threshold come from it unless "
                        "--batch-sizes/--thres override")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8327)
    # None: with --artifact an unset flag defers to the artifact's buckets and
    # threshold; with --ckpt it means 1 8 32 and 0.5
    p.add_argument("--batch-sizes", type=int, nargs="*", default=None)
    p.add_argument("--thres", type=float, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-kernel", action="store_true",
                   help="plain PyTorch attention instead of the CUDA kernel")
    p.add_argument("--coalesce", action="store_true",
                   help="dynamic-batch concurrent requests into one device "
                        "call per dispatch window")
    # legacy-.Model architecture flags
    p.add_argument("--d_model", type=int, default=32)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--dim_feedforward", type=int, default=16)
    p.add_argument("--num_encoder_layers", type=int, default=6)
    p.add_argument("--embedding_size_src", type=int, default=16)
    args = p.parse_args(argv)
    if bool(args.ckpt) == bool(args.artifact):
        p.error("exactly one of --ckpt / --artifact is required")
    kw = dict(use_kernel=False if args.no_kernel else None, coalesce=args.coalesce,
              device=args.device)

    if args.artifact:
        if args.batch_sizes is not None:
            kw["batch_sizes"] = args.batch_sizes
        if args.thres is not None:
            kw["thres"] = args.thres
        server = InfillServer.from_exported(args.artifact, **kw)
        print(f"serving artifact {args.artifact} (buckets {server.batch_sizes}, "
              f"{server.device}) on http://{args.host}:{args.port}/infill")
        return server.serve_http(host=args.host, port=args.port, block=block)

    legacy_config = GrooveTransformerConfig(
        d_model=args.d_model, n_heads=args.n_heads,
        dim_feedforward=args.dim_feedforward,
        num_encoder_layers=args.num_encoder_layers,
        embedding_size_src=args.embedding_size_src)
    state_dict, config, _ep, _loss = load_checkpoint(args.ckpt, legacy_config)
    server = InfillServer(
        state_dict, config,
        batch_sizes=args.batch_sizes if args.batch_sizes is not None else (1, 8, 32),
        thres=args.thres if args.thres is not None else 0.5, **kw)
    print(f"serving {args.ckpt} ({config.d_model}d/{config.num_encoder_layers}L, "
          f"{server.device}) on http://{args.host}:{args.port}/infill")
    return server.serve_http(host=args.host, port=args.port, block=block)


if __name__ == "__main__":
    main()
