"""Time design variants of the chains' long attention (the registers form of
``csrc/attn_regs_sm90.cuh``, launched through ``csrc/layer_attn_sm90.cu``)
against each other on one card.

    python scripts/chain_attention_variants.py scripts/chain_attention_variants.json \
        [--out chiprun_out/chain_attention_variants.json]

Each variant is the port's ``csrc/`` copied under
``build/chain_attention_variants/<name>`` with text replacements applied
(``edits``: [file, old, new]; none for the tree as it is) and
``layer_attn_sm90.cu`` compiled with nvcc like ``ops/_build.py``. The script
prints what ptxas reports of each registers-form kernel (registers, spills,
serialised wgmma), holds every variant to the plain versions
(``layer_sm90.attention_*_reference``, 2e-2 · max in bf16) at the spec's
``checks`` (T, causal; ``"nocheck": true`` skips a variant that computes
something else), then times each ``times`` row (T, causal, rate; B 32, d 256,
2 heads of 128, the slices of a packed qkv, bf16) through every variant in
turns, forward order then backward order: the forward's and the backward's
device time each from a CUDA graph of their calls (``chip_smoke.graph_ms``).
A variant whose library has ``tgi_probe_clusters(nt, nb)`` also reports the
clusters of the backward kernel the card holds at once. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import _build, fused_layer, layer_sm90  # noqa: E402

ROOT = _build.BUILD_ROOT.parent / "chain_attention_variants"
B, D, H = 32, 256, 2


def build(name: str, edits: list, flags: list) -> tuple:
    """The variant's library and ptxas' report of its registers-form kernels."""
    src = ROOT / name
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in edits:
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise ValueError(f"{name}: {fname} has no {old!r}")
        path.write_text(text.replace(old, new))
    lib = src / "liblayer_attn_sm90.so"
    run = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(src),
                          "-o", str(lib), str(src / "layer_attn_sm90.cu")],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"{name}: nvcc exit {run.returncode}\n{run.stderr[-3000:]}")
    lines = (run.stdout + run.stderr).splitlines()
    report = [line.split("ptxas info    : ")[-1] for line in lines
              if "Potential Performance Loss" in line and "regs" in line]
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "regs" in line:
            kernel = line.split("regs")[1].split("EEEvNS")[0]
            props = [x.split(":")[-1].strip() for x in lines[i + 1:i + 5]
                     if "spill" in x or "Used" in x]
            report.append(kernel + ": " + " | ".join(props))
    return lib, report


def kernels(lib_path) -> tuple:
    """A variant's (forward, backward) launches as counted kernels."""
    lib = ctypes.CDLL(str(lib_path))
    for entry in layer_sm90.ATTN_ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = layer_sm90.SIGNATURES[entry] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    error = lib.tgi_sm90_attn_error_string
    error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
    return lib, tuple(_build.CountedKernel(lambda: lib, entry, "tgi_sm90_attn_error_string")
                      for entry in layer_sm90.ATTN_ENTRIES)


def views(dev, t: int, seed: int):
    rng = np.random.default_rng(seed)
    rows = B * t

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    qkv = n(rows, 3 * D)
    dqkv = torch.empty_like(qkv)
    return ((qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]), n(rows, D),
            (dqkv[:, :D], dqkv[:, D:2 * D], dqkv[:, 2 * D:]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--out", default="chiprun_out/chain_attention_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chain_attention_variants needs a CUDA device")
    spec = json.loads(open(args.spec).read())
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(spec["variants"])) as pool:
        built = list(pool.map(
            lambda v: build(v["name"], v.get("edits", []), v.get("flags", [])), spec["variants"]))
    _, smi = cs.phase_device()
    result = {"nvidia_smi": smi, "build_s": time.time() - t0, "ptxas": {}, "checks": {},
              "clusters": {}, "times": []}
    libs = {}
    for v, (lib, report) in zip(spec["variants"], built):
        result["ptxas"][v["name"]] = report
        cdll, libs[v["name"]] = kernels(lib)
        if hasattr(cdll, "tgi_probe_clusters"):
            cdll.tgi_probe_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
            cdll.tgi_probe_clusters.restype = ctypes.c_int
            result["clusters"][v["name"]] = {f"nt{nt}_nb{nb}": cdll.tgi_probe_clusters(nt, nb)
                                             for nt in (2, 3, 4) for nb in (1, 2)}
    dev = torch.device("cuda")
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    for v in spec["variants"]:
        if v.get("nocheck"):
            continue
        fwd, bwd = libs[v["name"]]
        worst = 0.0
        for t, causal in spec.get("checks", []):
            (q, k, v_), da, (dq, dk, dv) = views(dev, t, 1)
            a = (seed, fused_layer.SITE_ATTN, 0.3, H, t, causal)
            out = layer_sm90.attention_forward(fwd, q, k, v_, *a)
            again = torch.empty_like(da)
            layer_sm90.attention_backward(bwd, q, k, v_, da, dq, dk, dv, again, *a)
            torch.cuda.synchronize()
            want = layer_sm90.attention_backward_reference(q, k, v_, da, *a)
            for got, ref in zip((dq, dk, dv, again, out), (*want, want[3])):
                err, top = cs.max_err(got, ref), float(ref.float().abs().max())
                cs.check(err <= 2e-2 * top, f"{v['name']} off its plain version at T {t} "
                                            f"causal={causal}: {err} > 2e-2 * {top}")
                worst = max(worst, err / top)
            cs.check(torch.equal(again, out), f"{v['name']}: the output again differs")
        result["checks"][v["name"]] = worst
    names = [v["name"] for v in spec["variants"]]
    for t, causal, rate in spec.get("times", []):
        (q, k, v_), da, (dq, dk, dv) = views(dev, t, 2)
        a = (seed, fused_layer.SITE_ATTN, rate, H, t, causal)
        again = torch.empty_like(da)
        row = {"t": t, "causal": causal, "rate": rate, "fwd_ms": {}, "bwd_ms": {}}
        for name in names + names[::-1]:
            fwd, bwd = libs[name]
            row["fwd_ms"].setdefault(name, []).append(cs.graph_ms(
                lambda: layer_sm90.attention_forward(fwd, q, k, v_, *a), n=10, reps=3))
            row["bwd_ms"].setdefault(name, []).append(cs.graph_ms(
                lambda: layer_sm90.attention_backward(bwd, q, k, v_, da, dq, dk, dv, again, *a),
                n=10, reps=3))
        result["times"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("nvidia_smi", "build_s", "ptxas", "checks",
                                             "clusters")}, indent=1))


if __name__ == "__main__":
    main()
