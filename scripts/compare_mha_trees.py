"""Time kernel #1 of two checkouts of the repository on one card, in turns.

    python scripts/compare_mha_trees.py --parent <dir> --change <dir> \
        [--out chiprun_out/compare_mha.json]

Each turn is a child process that imports one tree's port (its own
``csrc/``, built into its own ``build/``) and its ``chip_smoke.py`` helpers,
and times ``fused_mha`` at each row of ``ROWS`` (H 2, hd 128, packed qkv, the
inputs drawn on the card from one seed, so both trees see the same values):
the device time from a CUDA graph of its calls (``graph_ms``), the stream time
(host launch included, what a B 1 request pays), and SDPA on the same views
the same two ways. Turns run parent, change, change, parent. Each child also
holds the kernel to ``mha_reference`` at the row (``mha_tolerance``). Needs
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (T, B, dtype): the short route at T 32, the long route at 8, 16 and 64 bars
# and the train evaluator's forward at 8 bars
ROWS = [(32, 1, "float32"), (32, 512, "float32"), (32, 1, "bfloat16"), (32, 512, "bfloat16")]
ROWS += [(t, b, d) for t in (128, 256, 1024) for d in ("bfloat16", "float32") for b in (1, 512)]
ROWS += [(128, 3300, "bfloat16")]


def worker(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from transformergrooveinfilling_tpu_torch.ops import attention

    dev = torch.device("cuda")
    cs.phase_device()
    rng = torch.Generator(dev).manual_seed(24)
    for t, b, dname in ROWS:
        dtype = getattr(torch, dname)
        q, k, v = cs.mha_inputs(dev, rng, b, 2, 128, dtype, "packed_qkv", t)
        got = attention.fused_mha(q, k, v)
        want = attention.mha_reference(q.contiguous(), k.contiguous(), v.contiguous())
        atol, rtol = cs.mha_tolerance(dtype, want)
        cs.check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
                 f"{root}: fused_mha != mha_reference at T {t} B {b} {dname}")
        kern = lambda: attention.fused_mha(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        n = 3 if t * t * b > 2 ** 26 else 10
        print(json.dumps({
            "t": t, "b": b, "dtype": dname,
            "form": attention.route(q, k, v) if hasattr(attention, "route") else None,
            "device_ms": cs.graph_ms(kern, n=n, reps=2),
            "stream_ms": cs.time_us(kern, n, 2) / 1000.0,
            "sdpa_device_ms": cs.graph_ms(sdpa, n=n, reps=2),
            "sdpa_stream_ms": cs.time_us(sdpa, n, 2) / 1000.0,
            "max_abs_err": cs.max_err(got, want)}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--out", default="chiprun_out/compare_mha.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(os.path.abspath(args.worker))
        return
    turns = []
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(getattr(args, name))
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--parent", "-",
                              "--change", "-", "--worker", root], cwd=root,
                             capture_output=True, text=True, timeout=1500)
        if run.returncode:
            raise SystemExit(f"{name} turn failed (exit {run.returncode}):\n{run.stderr[-4000:]}")
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{") and '"t"' in line]
        device = next(json.loads(line) for line in run.stdout.splitlines()
                      if '"phase": "device"' in line)
        turns.append({"tree": name, "nvidia_smi": device["nvidia_smi"], "rows": rows})
        print(json.dumps({"turn": name, "rows": len(rows)}), flush=True)
    summary = []
    for i, (t, b, d) in enumerate(ROWS):
        row = {"t": t, "b": b, "dtype": d}
        for turn in turns:
            r = turn["rows"][i]
            for key in ("device_ms", "stream_ms", "sdpa_device_ms", "sdpa_stream_ms"):
                row.setdefault(f"{turn['tree']}_{key}", []).append(r[key])
            row[f"{turn['tree']}_form"] = r["form"]
        summary.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"turns": turns, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
