"""Time design variants of kernel #1 (``csrc/fused_mha.cu``) against each other
on one card.

    python scripts/mha_variants.py scripts/mha_variants.json [--out chiprun_out/mha_variants.json]

Each variant is the port's ``csrc/`` copied under ``build/mha_variants/<name>``
with text replacements applied (``edits``: [file, old, new]; none for the
tree as it is) and compiled with nvcc like ``ops/_build.py`` (plus any extra
``flags``). The script prints what ptxas reports of each flash kernel
(registers, spills, serialised wgmma), holds every variant to
``mha_reference`` at the spec's ``checks`` (both dtypes, causal and not;
``"nocheck": true`` skips a variant that computes something else), then times
each ``times`` row (T, B, dtype; H 2, hd 128, packed qkv) through every
variant in turns, forward then backward order, each from a CUDA graph of its
calls (``chip_smoke.graph_ms``), beside SDPA on the same views. Needs a card.
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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from transformergrooveinfilling_tpu_torch.ops import _build, attention  # noqa: E402

ROOT = _build.BUILD_ROOT.parent / "mha_variants"


def build(name: str, edits: list, flags: list) -> tuple:
    """The variant's library and ptxas' report of its flash kernels."""
    src = ROOT / name
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in edits:
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise ValueError(f"{name}: {fname} has no {old!r}")
        path.write_text(text.replace(old, new))
    lib = src / "libfused_mha.so"
    run = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
                          str(src / "fused_mha.cu")], capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"{name}: nvcc exit {run.returncode}\n{run.stderr[-3000:]}")
    lines = (run.stdout + run.stderr).splitlines()
    report = [line.split("ptxas info    : ")[-1] for line in lines
              if "Potential Performance Loss" in line]
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flash_kernel" in line:
            kernel = line.split("flash_kernel")[1].split("EEEvNS")[0]
            report.append(kernel + ": " + " | ".join(x.split(":")[-1].strip()
                                                     for x in lines[i + 1:i + 3]))
    return lib, report


def load(lib) -> ctypes.CDLL:
    cdll = ctypes.CDLL(str(lib))
    cdll.tgi_fused_mha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    cdll.tgi_fused_mha.restype = ctypes.c_int
    cdll.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.tgi_cuda_error_string.restype = ctypes.c_char_p
    return cdll


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec")
    ap.add_argument("--out", default="chiprun_out/mha_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mha_variants needs a CUDA device")
    spec = json.loads(open(args.spec).read())
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(spec["variants"])) as pool:
        built = list(pool.map(
            lambda v: build(v["name"], v.get("edits", []), v.get("flags", [])), spec["variants"]))
    _, smi = cs.phase_device()  # the card's name and power limit; TF32 off
    result = {"nvidia_smi": smi, "build_s": time.time() - t0, "ptxas": {}, "checks": {},
              "times": []}
    libs = {}
    for v, (lib, report) in zip(spec["variants"], built):
        result["ptxas"][v["name"]] = report
        libs[v["name"]] = load(lib)
    dev = torch.device("cuda")
    rng = torch.Generator(dev).manual_seed(5)

    def use(name):
        attention.KERNEL.library = lambda: libs[name]

    for v in spec["variants"]:
        if v.get("nocheck"):
            continue
        use(v["name"])
        worst = {}
        for b, h, t, hd, form in spec.get("checks", []):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v_ = cs.mha_inputs(dev, rng, b, h, hd, dtype, form, t)
                for causal in (False, True):
                    got = attention.fused_mha(q, k, v_, causal=causal)
                    torch.cuda.synchronize()
                    want = attention.mha_reference(q.contiguous(), k.contiguous(),
                                                   v_.contiguous(), causal)
                    atol, rtol = cs.mha_tolerance(dtype, want)
                    cs.check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
                             f"{v['name']} != mha_reference at {(b, h, t, hd)} {dtype} {form} "
                             f"causal={causal}")
                    key = str(dtype)[6:]
                    worst[key] = max(worst.get(key, 0.0), cs.max_err(got, want))
        result["checks"][v["name"]] = worst
    names = [v["name"] for v in spec["variants"]]
    for t, b, dname in spec.get("times", []):
        dtype = getattr(torch, dname)
        q, k, v_ = cs.mha_inputs(dev, rng, b, 2, 128, dtype, "packed_qkv", t)
        row = {"t": t, "b": b, "dtype": dname, "device_ms": {}}
        for name in names + names[::-1]:
            use(name)
            row["device_ms"].setdefault(name, []).append(
                cs.graph_ms(lambda: attention.fused_mha(q, k, v_), n=10, reps=3))
        row["sdpa_device_ms"] = cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v_),
                                            n=10, reps=3)
        result["times"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("nvidia_smi", "build_s", "ptxas", "checks")},
                     indent=1))


if __name__ == "__main__":
    main()
