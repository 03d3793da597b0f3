#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU
and check them.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, each printing one JSON line (any failure raises; the exit code is
then non-zero):

1. device   the card (``nvidia-smi`` name and power limit), torch and CUDA
            versions; TF32 is switched off for matmuls and cuDNN.
2. build    ``csrc/fused_mha.cu`` and ``csrc/fused_layer.cu`` compiled from
            this checkout with nvcc, one process each, in parallel; ptxas'
            registers, spills, stack and static shared memory per entry, and
            each layer kernel's dynamic shared memory at the flagship shape.
3. kernel   ``fused_mha`` against ``mha_reference`` on the card, at the
            serving shapes (B 1/8/32/512 × flagship H 2 hd 128 and demo H 4
            hd 8, T 32, causal off/on; f32 at atol 1e-5, bf16 at atol and
            rtol 2e-2), and both timed.
4. serve    ``InfillServer`` at the flagship width (configs/
            InfillingRandom_training.yaml: d 256, 2 heads, ff 512, 6 layers,
            16 in, 27 out; seeded random weights) on the card: the kernel's
            launch count over the direct requests is exactly 6 per forward
            chunk, and the answers match a ``use_kernel=False`` server on the
            same card and the plain path on the CPU; then again in bf16.
5. http     POST /infill, GET /healthz, a malformed body (400), and 8
            concurrent clients of a coalescing server against the direct path.
6. demo     the in-repo demo checkpoint served through ``serve.main``,
            answering an ``hvo_input`` request like the CPU plain path.
7. latency  B = 1 p50/p99, in-process and over loopback HTTP, and rows/s
            with requests of one full bucket (32), kernel and plain attention
            in turns; where a B = 1 request's host and device time goes.
8. layer    the whole-encoder-layer kernels (``fused_layer.cu``: forward,
            row backward, weight gradients) against
            ``encoder_layer_reference`` at the flagship shapes (d 256, 2
            heads, ff 512, T 32), B 32 and 512, f32 and bf16, dropout 0 and
            0.30 (the same Philox masks): y, the residuals, dx and the 12
            parameter grads; two runs with one seed bit-identical; forward
            and backward timed against the twin.
9. train    ``initialize_model`` + ``train_loop`` with the flagship YAML's
            hyperparameters (written here: the card's machine has no pyyaml;
            a CPU test holds them to the file) on seeded synthetic loops:
            the loss falls, every step launches each layer kernel once per
            layer; the same with ``fused_layer=False``; 3 f32 steps at
            dropout 0 against the plain paths on the card and on the CPU;
            training throughput at batch 32 and 512 and where a step's
            device time goes; the trained weights served by ``InfillServer``.

Then one line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from transformergrooveinfilling_tpu_torch import serve
from transformergrooveinfilling_tpu_torch.models import (
    GrooveTransformerConfig, build_model, predict, transformer,
)
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    load_legacy_checkpoint,
)
from transformergrooveinfilling_tpu_torch.ops import _build
from transformergrooveinfilling_tpu_torch.ops.attention import (
    fused_mha, mha_reference,
)
from transformergrooveinfilling_tpu_torch.ops import fused_layer as fl
from transformergrooveinfilling_tpu_torch.train import (
    initialize_model, make_train_step, train_loop,
)
from transformergrooveinfilling_tpu_torch.train.config import embedding_size_src_for

FLAGSHIP = GrooveTransformerConfig(  # configs/InfillingRandom_training.yaml
    d_model=256, n_heads=2, dim_feedforward=512, dropout=0.30,
    num_encoder_layers=6, embedding_size_src=16)
DEMO_FLAGS = ["--d_model", "32", "--n_heads", "4", "--dim_feedforward", "512",
              "--num_encoder_layers", "6", "--embedding_size_src", "27"]
DEMO_MODEL = "demo/transformer_run_demo_Epoch_799.Model"
BUCKETS = (1, 8, 32)
KERNEL_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_mha.cu"
TPU_KERNEL = "transformergrooveinfilling_tpu/ops/attention.py:25"
LAYER_SOURCE = "transformergrooveinfilling_tpu_torch/csrc/fused_layer.cu"
LAYER_TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel stands in for
    "fused_layer_fwd": "transformergrooveinfilling_tpu/ops/fused_layer.py:164",
    "fused_layer_bwd_rows": "transformergrooveinfilling_tpu/ops/fused_layer.py:236",
    "fused_layer_bwd_weights": "transformergrooveinfilling_tpu/ops/fused_layer.py:236",
}
# configs/InfillingRandom_training.yaml, written out (the card's machine has
# no pyyaml); tests/test_torch_train.py holds it to the file
FLAGSHIP_HP = {
    "experiment": "InfillingRandom", "batch_size": 32, "d_model": 256,
    "dim_feedforward": 512, "dropout": 0.30, "optimizer_algorithm": "sgd",
    "learning_rate": 0.089, "n_heads": 2, "num_encoder_decoder_layers": 6,
    "epochs": 500, "encoder_only": 1, "hit_loss_penalty": 0.73, "load_model": None,
}
LAYER_SHAPE = dict(d=256, h=2, ff=512, t=32)  # the flagship's encoder layer
THROUGHPUT_BATCHES = (32, 512)  # the YAML's batch and bench.py's
# 3 f32 steps, kernel path against the unfused plain path (cuBLAS), which
# cannot be given the kernel's side of a ReLU kink: one such unit in the first
# step moved a W1 row by 1.2e-4 on an H100, and the bar is about four times that
UNFUSED_BAR = 5e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((torch.as_tensor(a).float() - torch.as_tensor(b).float()).abs().max())


def time_us(fn, n: int = 200) -> float:
    """Mean µs per call on the stream, by CUDA events over ``n`` calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1000.0 / n


def device_us(fn, n: int = 50) -> dict:
    """Device time per call from the profiler, by kernel (or copy) name:
    ``{name: [µs per call, launches per call]}``, device-side events only,
    without the profiler's own buffer requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request":
            us, count = per_kernel.get(e.name[:70], (0.0, 0.0))
            per_kernel[e.name[:70]] = (us + e.time_range.elapsed_us() / n, count + 1 / n)
    return per_kernel


def host_us(fn, n: int = 200) -> float:
    """Host-clock µs per call of ``fn`` followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def hit_agreement(h, h_ref, sig_ref, margin=1e-4) -> bool:
    """Thresholded hits equal wherever the reference sigmoid is not within
    ``margin`` of 0.5."""
    sure = np.abs(sig_ref - 0.5) >= margin
    return bool(np.array_equal(h[sure], h_ref[sure]))


def post(port: int, payload=None, raw: bytes | None = None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/infill",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all(["fused_mha", "fused_layer"])  # one nvcc each, together
    for name in ("fused_mha", "fused_layer"):
        info = _build.build_info[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit({"phase": "build", "kernel": name, "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"], "ptxas": ptxas})
    d, h, ff, t = LAYER_SHAPE["d"], LAYER_SHAPE["h"], LAYER_SHAPE["ff"], LAYER_SHAPE["t"]
    emit({"phase": "build", "kernel": "fused_layer", "dynamic_smem_bytes_at_flagship": {
        "layer_fwd": fl.fwd_smem_bytes(t, d, ff),
        "layer_bwd_rows": fl.bwd_rows_smem_bytes(t, d, ff),
        "layer_bwd_weights": fl.bwd_weights_smem_bytes(t, d, h)},
        "limit": fl.MAX_SMEM_BYTES})


def phase_kernel(dev, rng) -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bars = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 2e-2)}
    for h, hd in ((2, 128), (4, 8)):
        for b in (1, 8, 32, 512):
            base = [rng.standard_normal((b, h, 32, hd)).astype(np.float32)
                    for _ in range(3)]
            for dtype, (atol, rtol) in bars.items():
                q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in base)
                for causal in (False, True):
                    got = fused_mha(q, k, v, causal=causal)
                    want = mha_reference(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    worst[dtype] = max(worst[dtype], err)
                    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
                    check(ok and got.dtype == dtype and got.shape == q.shape,
                          f"fused_mha != mha_reference at {(b, h, 32, hd)} {dtype} "
                          f"causal={causal}: max abs err {err}")
    timings = []
    for h, hd, b, dtype in ((2, 128, 1, torch.float32), (2, 128, 8, torch.float32),
                            (2, 128, 32, torch.float32), (2, 128, 512, torch.float32),
                            (2, 128, 1, torch.bfloat16), (2, 128, 512, torch.bfloat16),
                            (4, 8, 1, torch.float32)):
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, 32, hd)).astype(np.float32))
                   .to(dev, dtype) for _ in range(3))
        kern = lambda: fused_mha(q, k, v)  # noqa: E731
        plain = lambda: mha_reference(q, k, v)  # noqa: E731
        k1, p1, p2, k2 = time_us(kern), time_us(plain), time_us(plain), time_us(kern)
        dk, dp = device_us(kern), device_us(plain)
        timings.append({
            "shape": [b, h, 32, hd], "dtype": str(dtype).replace("torch.", ""),
            "kernel_us": [k1, k2], "plain_us": [p1, p2],
            "kernel_device_us": sum(us for us, _ in dk.values()),
            "plain_device_us": sum(us for us, _ in dp.values()),
            "plain_kernels_us": {k: us for k, (us, _) in dp.items()}})
    emit({"phase": "kernel", "max_abs_err": {"float32": worst[torch.float32],
                                             "bfloat16": worst[torch.bfloat16]},
          "bars": {"float32": {"atol": 1e-5}, "bfloat16": {"atol": 2e-2, "rtol": 2e-2}},
          "timings": timings})
    return {"max_abs_err": worst[torch.float32], "timings": timings}


def phase_serve(dev, rng, sd):
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    plain = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                               use_kernel=False)
    raw = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                             use_kernel=False, use_thres=False)
    check(srv.config.use_fused_attention and not plain.config.use_fused_attention,
          "kernel / plain servers are not configured as asked")
    xs = {n: rng.standard_normal((n, 32, 16)).astype(np.float32) for n in (1, 6, 40)}
    chunks = {1: 1, 6: 1, 40: 2}  # buckets (1, 8, 32): 1 | 8 | 32 + 8

    fused_mha.launches = 0  # the main path's run starts here
    out = {n: srv.infill(x) for n, x in xs.items()}
    launches = fused_mha.launches  # ... and ends here
    check(launches == 6 * sum(chunks.values()),
          f"fused_mha launched {launches} times, expected 6 per forward chunk "
          f"({6 * sum(chunks.values())})")

    worst = 0.0
    for n, x in xs.items():
        y, yp, yr = out[n], plain.infill(x), raw.infill(x)
        check(y.shape == (n, 32, 27) and np.isfinite(y).all(), f"bad output at N={n}")
        check(set(np.unique(y[..., :9])) <= {0.0, 1.0}, "hits not thresholded")
        err = max_err(y[..., 9:], yp[..., 9:])
        worst = max(worst, err)
        check(err <= 1e-4, f"kernel vs plain server at N={n}: v/o differ by {err}")
        check(hit_agreement(y[..., :9], yp[..., :9], yr[..., :9]),
              f"kernel vs plain server at N={n}: hits differ away from the threshold")

    # the plain path on the CPU, the one the CPU tests hold against JAX
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    h_cpu, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs[6]))
    cpu_err = max(max_err(out[6][..., 9:18], v_cpu), max_err(out[6][..., 18:], o_cpu))
    check(cpu_err <= 1e-4, f"card vs CPU plain path: v/o differ by {cpu_err}")

    bf16_cfg = dataclasses.replace(FLAGSHIP, compute_dtype=torch.bfloat16)
    srv16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev)
    plain16 = serve.InfillServer(sd, bf16_cfg, batch_sizes=BUCKETS, device=dev,
                                 use_kernel=False)
    before = fused_mha.launches
    y16 = srv16.infill(xs[40])
    check(fused_mha.launches - before == 6 * chunks[40], "bf16 run missed the kernel")
    check(np.isfinite(y16).all(), "bf16 output not finite")
    err16_plain = max_err(y16[..., 9:], plain16.infill(xs[40])[..., 9:])
    check(err16_plain <= 2e-2, f"bf16 kernel vs plain server: v/o differ by {err16_plain}")
    emit({"phase": "serve", "config": "InfillingRandom flagship d256 h2 ff512 6L",
          "requests": sorted(xs), "chunks": sum(chunks.values()), "launches": launches,
          "max_abs_err_vs_plain_server": worst, "max_abs_err_vs_cpu_plain": cpu_err,
          "bf16": {"max_abs_dev_vs_f32": max_err(y16[..., 9:], out[40][..., 9:]),
                   "hit_flip_share_vs_f32": float((y16[..., :9] != out[40][..., :9]).mean()),
                   "max_abs_err_vs_bf16_plain_server": err16_plain}})
    return srv, plain, raw, launches


def phase_http(dev, rng, sd, srv, raw) -> None:
    httpd = srv.serve_http(port=0, block=False)
    coal = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev,
                              coalesce=True, coalesce_wait_ms=5.0)
    httpd_c = coal.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        for n in (1, 3):
            x = rng.standard_normal((n, 32, 16)).astype(np.float32)
            code, payload = post(port, {"input": x.tolist()})
            check(code == 200, f"POST /infill answered {code}: {payload}")
            check(np.array_equal(np.asarray(payload["hvo"], np.float32), srv.infill(x)),
                  "HTTP answer differs from the direct path")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            body = r.read()
        health = json.loads(body)
        check(b"NaN" not in body and health["ok"] and health["count"] >= 2,
              f"bad /healthz: {body!r}")
        code, bad = post(port, raw=b"{not json")
        check(code == 400 and "error" in bad, f"malformed body answered {code}")

        xs = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(32)]
        got, errs = [None] * len(xs), []

        def client(ids):
            try:
                for i in ids:
                    c, p = post(httpd_c.server_address[1], {"input": xs[i].tolist()})
                    got[i] = (c, np.asarray(p.get("hvo"), np.float32))
            except Exception as e:  # reported below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(range(j, 32, 8),))
                   for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errs and not any(t.is_alive() for t in threads),
              f"coalesced clients failed: {errs}")
        worst = 0.0
        for x, (c, y) in zip(xs, got):
            check(c == 200, f"coalesced request answered {c}")
            want, sig = srv.infill(x), raw.infill(x)
            worst = max(worst, max_err(y[:, 9:], want[:, 9:]))
            check(hit_agreement(y[:, :9], want[:, :9], sig[:, :9]),
                  "coalesced hits differ from the direct path")
        # batch composition changes the products' shapes, hence f32 rounding
        check(worst <= 1e-5, f"coalesced v/o differ from the direct path by {worst}")
        emit({"phase": "http", "posts": 2, "healthz": health, "malformed": code,
              "coalesced_clients": 8, "coalesced_requests": len(xs),
              "coalesced_max_abs_err_vs_direct": worst})
    finally:
        for h in (httpd, httpd_c):
            h.shutdown()
            h.server_close()


def phase_demo(rng) -> None:
    before = fused_mha.launches
    httpd = serve.main(["--ckpt", "demo", "--port", "0"] + DEMO_FLAGS, block=False)
    try:
        grid = (rng.random((32, 27)) < 0.25).astype(np.float32)
        code, payload = post(httpd.server_address[1], {"hvo_input": grid.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(code == 200, f"demo hvo_input answered {code}: {payload}")
    y = np.asarray(payload["hvo"], np.float32)
    check(y.shape == (32, 27) and np.isfinite(y).all(), "bad demo answer")
    cfg = GrooveTransformerConfig(d_model=32, n_heads=4, dim_feedforward=512,
                                  num_encoder_layers=6, embedding_size_src=27)
    sd, epoch, _loss = load_legacy_checkpoint(DEMO_MODEL, cfg)
    model = build_model(cfg, "cpu")
    model.load_state_dict(sd, strict=True)
    h, v, o = predict(model, torch.from_numpy(grid[None]))
    sig = predict(model, torch.from_numpy(grid[None]), use_thres=False)[0].numpy()[0]
    err = max(max_err(y[:, 9:18], v[0]), max_err(y[:, 18:], o[0]))
    check(err <= 1e-4, f"demo answer vs CPU plain path: v/o differ by {err}")
    check(hit_agreement(y[:, :9], h[0].numpy(), sig), "demo hits differ")
    launches = fused_mha.launches - before
    check(launches >= 6, "the demo server did not run the kernel")
    emit({"phase": "demo", "checkpoint": DEMO_MODEL, "epoch": epoch,
          "max_abs_err_vs_cpu_plain": err, "hits": int(y[:, :9].sum()),
          "launches_incl_warmup": launches})


def phase_latency(dev, srv, plain) -> dict:
    runs = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):  # in turns
        runs[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=500, batch=1))
    batch32 = {"kernel": [], "plain": []}  # one full bucket-32 chunk per request
    for which in ("kernel", "plain", "plain", "kernel"):
        batch32[which].append(serve.latency_benchmark(
            srv if which == "kernel" else plain, n_requests=200, batch=32))
    httpd = srv.serve_http(port=0, block=False)
    try:
        http = serve.latency_benchmark(
            srv, n_requests=300, batch=1,
            url=f"http://127.0.0.1:{httpd.server_address[1]}/infill")
    finally:
        httpd.shutdown()
        httpd.server_close()
    # where a B = 1 request's time goes
    x = np.zeros((1, 32, 16), np.float32)
    xd = torch.zeros((1, 32, 16), device=dev)
    request = host_us(lambda: srv.infill(x))
    forward = host_us(lambda: srv._forward(xd))
    plain_forward = host_us(lambda: plain._forward(xd))
    copies = host_us(lambda: torch.from_numpy(x).to(dev).cpu())
    per_kernel = device_us(lambda: srv.infill(x), n=50)
    device_total = sum(us for us, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "latency", "batch": 1, "in_process_kernel": runs["kernel"],
          "in_process_plain": runs["plain"], "http_kernel": http,
          "batch32_kernel": batch32["kernel"], "batch32_plain": batch32["plain"],
          "batch32_rows_per_s_kernel": [32e3 / r["mean_ms"] for r in batch32["kernel"]],
          "batch32_rows_per_s_plain": [32e3 / r["mean_ms"] for r in batch32["plain"]],
          "breakdown_us": {"request": request, "forward": forward,
                           "plain_forward": plain_forward, "copy_in_out": copies},
          "request_device_us": device_total,
          "device_launches_per_request": sum(c for _, c in per_kernel.values()),
          "device_busy_share": device_total / request,
          "top_device_kernels_us_launches": top})
    return {"in_process": runs["kernel"][0], "http": http}


def layer_case(dev, rng, b: int, dtype):
    """Flagship-shaped layer inputs from ``rng``: (args without the seed, dy)."""
    d, ff = LAYER_SHAPE["d"], LAYER_SHAPE["ff"]
    m = b * LAYER_SHAPE["t"]

    def n(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    x = n(m, d).to(dtype)
    # nn.Linear's (out, in) layout
    wqkv, wo, w1, w2 = (n(3 * d, d, scale=d ** -0.5).to(dtype), n(d, d, scale=d ** -0.5).to(dtype),
                        n(ff, d, scale=d ** -0.5).to(dtype), n(d, ff, scale=ff ** -0.5).to(dtype))
    return [x, wqkv, n(3 * d, scale=0.1), wo, n(d, scale=0.1), n(d, scale=0.1, offset=1.0),
            n(d, scale=0.1), w1, n(ff, scale=0.1), w2, n(d, scale=0.1),
            n(d, scale=0.1, offset=1.0), n(d, scale=0.1)], n(m, d).to(dtype)


GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "db1", "dw1", "db1f", "dw2",
              "db2f", "dg2", "db2")


def layer_backward_args(args, res, seed):
    x, wqkv, _, wo, _, g1, b1, w1, _, w2, _, g2, _ = args
    _, qkv, a1, h, a2 = res
    return (x, qkv, a1, h, a2, wqkv, wo, w1, w2, g1, b1, g2, seed)


def phase_layer(dev, rng) -> dict:
    """The three layer kernels against ``encoder_layer_reference`` on the
    card. Bars: f32 atol 1e-4 on y and the residuals, and 1e-4 · max|grad|
    on each grad (sums taken in another order); bf16 2e-2 · max|ref| on
    everything (bf16 rounds P, attention, y1, h and the weight grads, and the
    kernel rounds its backward's intermediates where the TPU kernel does,
    autograd does not). The masks are equal (the same Philox bytes). A hidden
    unit within rounding of 0 may fall on either side of the ReLU's kink: the
    twin takes the kernel's side at such units only (``kink_flips``: within
    ``KINK_BAND`` of 0, and few), and its own everywhere else."""
    h_, t = LAYER_SHAPE["h"], LAYER_SHAPE["t"]
    checks, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy = layer_case(dev, rng, b, dtype)
            for rate in (0.0, 0.3):
                seed = torch.tensor([1234 + b], dtype=torch.int32, device=dev)
                res = fl.layer_forward(*args, seed, rate, h_, t)
                grads = fl.layer_backward(dy, *layer_backward_args(args, res, seed), rate, h_, t)
                res2 = fl.layer_forward(*args, seed, rate, h_, t)
                grads2 = fl.layer_backward(dy, *layer_backward_args(args, res2, seed), rate, h_, t)
                torch.cuda.synchronize()
                bitwise = all(torch.equal(u, v) for u, v in zip(res + grads, res2 + grads2))
                check(bitwise, f"two runs with one seed differ at B {b} {dtype} rate {rate}")
                with torch.no_grad():
                    own = fl.encoder_layer_reference(*args, seed, rate, h_, t,
                                                     return_residuals=True)
                flips, kink = fl.kink_flips(own[3], res[3])
                leaves = [a.detach().clone().requires_grad_(True) for a in args]
                want = fl.encoder_layer_reference(*leaves, seed, rate, h_, t,
                                                  return_residuals=True, relu_flips=flips)
                want[0].backward(dy)
                errs = {}
                for name, g, w in zip(("y", "qkv", "a1", "h", "a2"), res, want):
                    w = w.detach().float()
                    bar = 1e-4 if dtype == torch.float32 else 2e-2 * float(w.abs().max())
                    errs[name] = max_err(g, w)
                    check(errs[name] <= bar, f"{name} at B {b} {dtype} rate {rate}: "
                                             f"{errs[name]} > {bar}")
                for name, g, leaf in zip(GRAD_NAMES, grads, leaves):
                    w = leaf.grad.float()
                    rel = 1e-4 if dtype == torch.float32 else 2e-2
                    errs[name] = max_err(g, w)
                    check(errs[name] <= rel * float(w.abs().max()),
                          f"{name} at B {b} {dtype} rate {rate}: {errs[name]} > "
                          f"{rel} * {float(w.abs().max())}")
                worst[dtype] = max(worst[dtype], *errs.values())
                checks.append({"B": b, "dtype": str(dtype)[6:], "rate": rate,
                               "max_abs_err": errs, "bitwise_repeat": bitwise,
                               "relu_kink_flips": kink})
    timings = []
    for b, dtype in ((32, torch.bfloat16), (512, torch.bfloat16), (32, torch.float32),
                     (512, torch.float32)):
        args, dy = layer_case(dev, rng, b, dtype)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        res = fl.layer_forward(*args, seed, 0.3, h_, t)
        bargs = layer_backward_args(args, res, seed)
        leaves = [a.detach().clone().requires_grad_(True) for a in args]
        y_ref = fl.encoder_layer_reference(*leaves, seed, 0.3, h_, t)
        n = 50 if b == 32 else 10  # calls per timing, after 10 warm-up calls
        kf = lambda: fl.layer_forward(*args, seed, 0.3, h_, t)  # noqa: E731
        kb = lambda: fl.layer_backward(dy, *bargs, 0.3, h_, t)  # noqa: E731

        def pf():
            with torch.no_grad():
                fl.encoder_layer_reference(*args, seed, 0.3, h_, t)

        pb = lambda: torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)  # noqa: E731
        row = {"B": b, "dtype": str(dtype)[6:], "rate": 0.3}
        for key, k, p in (("fwd", kf, pf), ("bwd", kb, pb)):
            k1, p1, p2, k2 = (time_us(f, n) / 1000.0 for f in (k, p, p, k))
            row[f"{key}_kernel_ms"], row[f"{key}_plain_ms"] = [k1, k2], [p1, p2]
        dev_k = device_us(lambda: (kf(), kb()), n=3)
        row["kernel_device_us"] = {k: us for k, (us, _) in dev_k.items()}
        dev_f, dev_b = device_us(pf, n=3), device_us(pb, n=3)
        row["plain_fwd_device_us"] = sum(us for us, _ in dev_f.values())
        row["plain_bwd_device_us"] = sum(us for us, _ in dev_b.values())
        timings.append(row)
    emit({"phase": "layer", "shape": LAYER_SHAPE, "checks": checks,
          "bars": {"float32": "1e-4 abs (y, residuals); 1e-4 * max|grad| (grads)",
                   "bfloat16": "2e-2 * max|ref|"},
          "timings": timings})
    return {"max_abs_err": worst, "timings": timings}


def flagship_params(**model):
    """``initialize_model``'s params from ``FLAGSHIP_HP``."""
    hp = FLAGSHIP_HP
    return {"model": {"d_model": hp["d_model"], "n_heads": hp["n_heads"],
                      "dim_feedforward": hp["dim_feedforward"], "dropout": hp["dropout"],
                      "num_encoder_layers": hp["num_encoder_decoder_layers"],
                      "embedding_size_src": embedding_size_src_for(hp["experiment"]),
                      "optimizer": hp["optimizer_algorithm"], **model},
            "training": {"learning_rate": hp["learning_rate"], "batch_size": hp["batch_size"],
                         "seed": 0},
            "load_model": hp["load_model"]}


class Loops:
    """Seeded synthetic loops (bench.py's recipe): ``processed_inputs``
    (N, 32, 16) normal, ``processed_outputs`` HVO grids with 30 % hits."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.processed_inputs = rng.standard_normal((n, 32, 16)).astype(np.float32)
        h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
        self.processed_outputs = np.concatenate(
            [h, h * rng.random(h.shape), h * (rng.random(h.shape) - 0.5)], axis=2
        ).astype(np.float32)


def launches() -> dict:
    return {name: f.launches for name, f in fl.KERNELS.items()}


def reset_launches() -> None:
    for f in fl.KERNELS.values():
        f.launches = 0


def run_epochs(bundle, data, held, epochs: int, batch: int) -> list:
    return [train_loop(dataset=data, groove_transformer=bundle, epoch=e, batch_size=batch,
                       hit_loss_penalty=FLAGSHIP_HP["hit_loss_penalty"],
                       validation_inputs=held.processed_inputs,
                       validation_gt=held.processed_outputs) for e in range(epochs)]


def seqs_per_s(bundle, data, batch: int) -> float:
    """One epoch through ``train_loop`` (it ends in the metrics' fetch)."""
    t0 = time.perf_counter()
    train_loop(dataset=data, groove_transformer=bundle, batch_size=batch,
               hit_loss_penalty=FLAGSHIP_HP["hit_loss_penalty"])
    return len(data.processed_inputs) / (time.perf_counter() - t0)


def phase_train(dev, rng) -> dict:
    data, held = Loops(2048, 1), Loops(256, 2)
    batch, epochs = FLAGSHIP_HP["batch_size"], 3
    steps = epochs * (len(data.processed_inputs) // batch)
    bundle, _, _ = initialize_model(flagship_params(), dev)
    check(bundle.config.fused_layer and bundle.config.compute_dtype == torch.bfloat16,
          f"auto policy did not pick the kernel in bf16: {bundle.config}")
    reset_launches()  # the main path's run starts here
    fused_mha.launches = 0
    t0 = time.perf_counter()
    metrics = run_epochs(bundle, data, held, epochs, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()  # ... and ends here
    n_layers = FLAGSHIP_HP["num_encoder_decoder_layers"]
    check(all(c == steps * n_layers for c in counts.values()),
          f"layer kernels launched {counts}, expected {steps * n_layers} each "
          f"({steps} steps x {n_layers} layers)")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite: {metrics}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    plain, _, _ = initialize_model(flagship_params(fused_layer=False), dev)
    before = launches()
    plain_metrics = run_epochs(plain, data, held, epochs, batch)
    plain_losses = [m["loss"] for m in plain_metrics]
    check(launches() == before, "fused_layer=False launched a layer kernel")
    check(all(np.isfinite(plain_losses)) and plain_losses[-1] < plain_losses[0],
          f"plain path loss did not fall: {plain_losses}")

    # 3 f32 steps at dropout 0: the kernel path against its twin on the card
    # and on the CPU. A hidden unit within rounding of 0 can fall on either
    # side of the ReLU's kink, and one such unit moves a W1 row by lr·|grad|
    # (on an H100: one unit of layer 1 in the first step, 1.2e-4). So the
    # kernel path records its h_drop for each layer and step, and the twins
    # take the kernel's side at the units where ``kink_flips`` finds the two
    # within rounding of 0, their own side everywhere else. The unfused plain
    # path on the card cannot; it is held to UNFUSED_BAR.
    kernel_h, kinks = [], []

    def recording_kernel(*a):
        kernel_h.append(fl.layer_forward(*[t.detach() for t in a[:14]], *a[14:])[3])
        return fl.encoder_layer_train(*a)

    def replaying_twin(*a):
        with torch.no_grad():
            own_h = fl.encoder_layer_reference(*[t.detach() for t in a[:14]], *a[14:],
                                               return_residuals=True)[3]
        flips, kink = fl.kink_flips(own_h, next(replay).to(own_h.device))
        kinks.append(kink["flips"])
        return fl.encoder_layer_reference(*a, relu_flips=flips)

    x = torch.from_numpy(data.processed_inputs[:96]).to(dev)
    y = torch.from_numpy(data.processed_outputs[:96]).to(dev)
    three = {}
    for name, device, fused in (("kernel", dev, True), ("card_twin", dev, True),
                                ("cpu_twin", torch.device("cpu"), True),
                                ("card_unfused", dev, False)):
        b, _, _ = initialize_model(flagship_params(bf16=False, dropout=0.0, fused_layer=fused),
                                   device)
        step = make_train_step(FLAGSHIP_HP["hit_loss_penalty"])
        gen = torch.Generator(device).manual_seed(0)
        saved = transformer.encoder_layer_train
        replay = iter(kernel_h)
        if name == "kernel":
            transformer.encoder_layer_train = recording_kernel
        elif name.endswith("twin"):
            transformer.encoder_layer_train = replaying_twin
        try:
            for i in range(3):
                step(b.state, x[32 * i:32 * i + 32].to(device),
                     y[32 * i:32 * i + 32].to(device), None, gen)
        finally:
            transformer.encoder_layer_train = saved
        three[name] = {k: v.detach().cpu() for k, v in b.model.state_dict().items()}
    param_err = {other: max(max_err(three["kernel"][k], three[other][k]) for k in three["kernel"])
                 for other in ("card_twin", "cpu_twin", "card_unfused")}
    check(max(param_err["card_twin"], param_err["cpu_twin"]) <= 1e-4
          and param_err["card_unfused"] <= UNFUSED_BAR,
          f"3 f32 steps: params differ by {param_err} (kink flips per layer call: {kinks})")

    # throughput, kernel / twin / unfused in turns, at batch 32 and bench.py's 512
    throughput = {}
    for b in THROUGHPUT_BATCHES:
        runs = {"kernel": [], "twin": [], "unfused": []}
        models = {"kernel": initialize_model(flagship_params(), dev)[0],
                  "twin": initialize_model(flagship_params(), dev)[0],
                  "unfused": initialize_model(flagship_params(fused_layer=False), dev)[0]}
        for which in ("kernel", "twin", "unfused", "unfused", "twin", "kernel"):
            saved = transformer.encoder_layer_train
            if which == "twin":
                transformer.encoder_layer_train = fl.encoder_layer_reference
            try:
                seqs_per_s(models[which], data, b)  # warm-up epoch
                runs[which].append(seqs_per_s(models[which], data, b))
            finally:
                transformer.encoder_layer_train = saved
        throughput[b] = runs

    # where a step's device time goes (kernel path)
    breakdown = {}
    for b in THROUGHPUT_BATCHES:
        small = Loops(2 * b, 3)
        bnd = initialize_model(flagship_params(), dev)[0]
        seqs_per_s(bnd, small, b)
        t0 = time.perf_counter()
        seqs_per_s(bnd, small, b)
        host = (time.perf_counter() - t0) / 2
        per_kernel = device_us(lambda: seqs_per_s(bnd, small, b), n=2)
        total = sum(us for us, _ in per_kernel.values()) / 2
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        breakdown[b] = {"step_host_ms": host * 1e3, "step_device_ms": total / 1e3,
                        "device_busy_share": total / 1e6 / host,
                        "launches_per_step": sum(c for _, c in per_kernel.values()) / 2,
                        "top_kernels_us_per_step": {k: us / 2 for k, (us, _) in top}}

    # the trained weights served by the serving slice, against the CPU plain path
    sd = {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}
    srv = serve.InfillServer(sd, FLAGSHIP, batch_sizes=BUCKETS, device=dev)
    xs = rng.standard_normal((6, 32, 16)).astype(np.float32)
    served = srv.infill(xs)
    cpu_model = build_model(FLAGSHIP, "cpu")
    cpu_model.load_state_dict(sd, strict=True)
    _, v_cpu, o_cpu = predict(cpu_model, torch.from_numpy(xs))
    serve_err = max(max_err(served[..., 9:18], v_cpu), max_err(served[..., 18:], o_cpu))
    check(serve_err <= 1e-4, f"trained weights served: v/o differ from the CPU by {serve_err}")
    emit({"phase": "train", "config": FLAGSHIP_HP, "data": "2048 seeded synthetic loops",
          "epochs": epochs, "steps": steps, "seconds": seconds, "launches": counts,
          "losses": losses, "last_metrics": metrics[-1], "plain_losses": plain_losses,
          "three_f32_steps_param_err": param_err,
          "three_f32_steps_kink_flips": kinks, "unfused_bar": UNFUSED_BAR,
          "seqs_per_s": throughput, "step_breakdown": breakdown,
          "served_max_abs_err_vs_cpu": serve_err})
    return {"launches": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    name, smi = phase_device()
    phase_build()
    kernel = phase_kernel(dev, rng)
    torch.manual_seed(0)  # seeded random flagship weights
    sd = build_model(FLAGSHIP, "cpu").state_dict()
    srv, plain, raw, launches_mha = phase_serve(dev, rng, sd)
    phase_http(dev, rng, sd, srv, raw)
    phase_demo(rng)
    phase_latency(dev, srv, plain)
    layer = phase_layer(dev, rng)
    train = phase_train(dev, rng)
    b1 = next(t for t in kernel["timings"]
              if t["shape"] == [1, 2, 32, 128] and t["dtype"] == "float32")
    at32 = next(t for t in layer["timings"] if t["B"] == 32 and t["dtype"] == "bfloat16")
    layer_err = layer["max_abs_err"][torch.float32]
    kernels = [{
        "name": "fused_mha", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches_mha,
        "max_abs_err": kernel["max_abs_err"],
        "ms": float(np.mean(b1["kernel_us"])) / 1000.0,
        "plain_ms": float(np.mean(b1["plain_us"])) / 1000.0,
        "at": "B 1, H 2, T 32, hd 128, float32; err over all f32 checks"}]
    for kname in fl.KERNELS:
        device_ms = sum(us for k, us in at32["kernel_device_us"].items()
                        if fl.KERNELS[kname].entry.removeprefix("tgi_") in k) / 1000.0
        plain = at32["fwd_plain_ms"] if kname.endswith("fwd") else at32["bwd_plain_ms"]
        kernels.append({
            "name": kname, "route": "cuda", "source": LAYER_SOURCE,
            "replaces": LAYER_TPU_KERNELS[kname], "launches": train["launches"][kname],
            "max_abs_err": layer_err, "ms": device_ms, "plain_ms": float(np.mean(plain)),
            "at": "B 32, T 32, d 256, 2 heads, ff 512, bf16, rate 0.30; ms: device time "
                  "per call; plain_ms: the twin's whole forward (fwd) or autograd backward "
                  "(both backward kernels) on the stream; err: the largest over the f32 "
                  "layer checks (y, residuals, dx, 12 grads; B 32 and 512; rate 0 and 0.30)"})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
