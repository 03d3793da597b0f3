"""The port's serving artifacts (``export.py``) against the JAX package's, on
the CPU: a JAX artifact served by the port's ``load_infill`` and
``InfillServer.from_exported`` as JAX's ``load_infill`` serves it; the port's
artifact against the port's ``InfillServer`` at every bucket, and its
``params.msgpack`` read by flax into the JAX server; each program's empty
``state_dict`` and its ``tgi::fused_mha`` nodes, one an attention; a program
moved to ``"meta"``; the guards with JAX's messages; ``serve --artifact``
over HTTP; loading a program without the model code."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu import export as jax_export
from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.serve import InfillServer as JaxInfillServer
from transformergrooveinfilling_tpu_torch import export, serve
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig
from transformergrooveinfilling_tpu_torch.models import transformer
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    state_dict_from_flax_params,
)
from transformergrooveinfilling_tpu_torch.ops import attention
from transformergrooveinfilling_tpu_torch.serve import InfillServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(d_model=32, n_heads=4, dim_feedforward=48, num_encoder_layers=2,
            max_len=32, embedding_size_src=16)
FAMILIES = {"encoder": 0, "encdec": 2}  # decoder layers
BUCKETS = (2, 4)
HV_ATOL = 3e-5  # v/o between the two packages (tests/test_torch_parity.py's bar)


def _configs(family):
    dec = FAMILIES[family]
    return (JaxConfig(dropout=0.0, num_decoder_layers=dec, **ARCH),
            GrooveTransformerConfig(dropout=0.0, num_decoder_layers=dec, **ARCH))


def _jax_params(cfg, seed):
    """Seeded JAX parameters, moved off flax's init by seeded noise so the
    hits are not all at the threshold."""
    params = jax_build_model(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, cfg.embedding_size_src)),
        deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _inputs(n=5, seed=0):
    # n = 5 over buckets (2, 4): a chunk of 4, then 1 padded to 2
    return np.random.default_rng(seed).standard_normal((n, 32, 16)).astype(np.float32)


def _assert_like(got, want, probs):
    """JAX's own rule (tests/test_export.py): v/o close, hits equal where the
    probability is not at the threshold's knife-edge, on > 90 % of them."""
    np.testing.assert_allclose(got[..., 9:], want[..., 9:], atol=HV_ATOL, rtol=0)
    away = np.abs(probs - 0.5) > 1e-4
    np.testing.assert_array_equal(got[..., :9][away], want[..., :9][away])
    assert away.mean() > 0.9


@pytest.fixture(scope="module")
def weights():
    """Per family: (JAX config, port config, JAX params, port state dict)."""
    out = {}
    for family in FAMILIES:
        jcfg, cfg = _configs(family)
        params = _jax_params(jcfg, 1)
        out[family] = (jcfg, cfg, params, state_dict_from_flax_params(params, cfg))
    return out


@pytest.fixture(scope="module")
def port_artifacts(weights, tmp_path_factory):
    """Per family: the port's artifact of its weights (buckets 2 and 4)."""
    root = tmp_path_factory.mktemp("port_artifacts")
    return {family: export.export_infill(sd, cfg, str(root / f"{family}.tgix"),
                                         batch_sizes=BUCKETS)
            for family, (_, cfg, _, sd) in weights.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("use_thres", [True, False])
def test_jax_artifact_served_by_the_port_like_jax(weights, tmp_path, family, use_thres):
    jcfg, _cfg, params, _sd = weights[family]
    path = str(tmp_path / "jax.tgix")
    jax_export.export_infill(params, jcfg, path, batch_sizes=BUCKETS, use_thres=use_thres,
                             platforms=("cpu",))
    x = _inputs()
    want = jax_export.load_infill(path).predict(x)
    probs = JaxInfillServer(params, jcfg, batch_sizes=(4,), use_thres=False,
                            use_pallas=False).infill(x)[..., :9]
    loaded = export.load_infill(path, device="cpu")
    assert loaded.batch_sizes == list(BUCKETS)
    server = InfillServer.from_exported(path, device="cpu")
    assert server.batch_sizes == list(BUCKETS) and server.use_thres == use_thres
    for got in (loaded.predict(x), server.infill(x)):
        assert got.shape == (5, 32, 27)
        if use_thres:
            _assert_like(got, want, probs)
        else:
            np.testing.assert_allclose(got, want, atol=HV_ATOL, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_artifact_equals_the_port_server_at_every_bucket(weights, port_artifacts,
                                                              family):
    _jcfg, cfg, _params, sd = weights[family]
    loaded = export.load_infill(port_artifacts[family], device="cpu")
    server = InfillServer(sd, cfg, batch_sizes=BUCKETS, device="cpu")
    assert loaded.batch_sizes == list(BUCKETS)
    assert (loaded.max_len, loaded.embedding_size_src) == (32, 16)
    for n in (1, 2, 3, 4, 5, 9):
        x = _inputs(n, seed=n)
        assert loaded._bucket(n) == server._bucket(n)
        got = loaded.predict(x)
        np.testing.assert_allclose(got, server.infill(x), atol=1e-5, rtol=0)
        assert set(np.unique(got[..., :9])) <= {0.0, 1.0}
    x = _inputs(1)[0]
    np.testing.assert_allclose(loaded(x), server.infill(x), atol=1e-5, rtol=0)
    assert loaded(x).shape == (32, 27)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_artifact_params_restore_into_the_jax_server(weights, port_artifacts, family):
    from flax import serialization

    from transformergrooveinfilling_tpu.train.checkpoint import config_from_json_dict

    path = port_artifacts[family]
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        params = serialization.msgpack_restore(z.read("params.msgpack"))
    assert set(meta) == {"artifact_version", "config", "batch_sizes", "use_thres", "thres",
                         "platforms", "jax_version", "torch_version"}
    assert meta["platforms"] == ["cpu", "cuda"] and meta["jax_version"] is None
    assert meta["torch_version"] == torch.__version__
    jcfg = config_from_json_dict(meta["config"])
    x = _inputs()
    jax_server = JaxInfillServer(params, jcfg, batch_sizes=BUCKETS, use_pallas=False)
    probs = JaxInfillServer(params, jcfg, batch_sizes=(4,), use_thres=False,
                            use_pallas=False).infill(x)[..., :9]
    _assert_like(export.load_infill(path, device="cpu").predict(x), jax_server.infill(x), probs)


@pytest.mark.parametrize("family, attentions, causal", [("encoder", 2, 0), ("encdec", 6, 2)])
def test_programs_hold_no_weights_and_one_kernel_node_an_attention(weights, port_artifacts,
                                                                   family, attentions, causal):
    _jcfg, cfg, _params, sd = weights[family]
    with zipfile.ZipFile(port_artifacts[family]) as z:
        assert sorted(n for n in z.namelist() if n.startswith("bucket_")) == [
            "bucket_2.pt2", "bucket_4.pt2"]
        for b in BUCKETS:
            ep = torch.export.load(io.BytesIO(z.read(f"bucket_{b}.pt2")))
            assert ep.state_dict == {} and ep.example_inputs is None
            # the only constants are the positional tables, (1, T, d) each
            assert all(tuple(c.shape) == (1, 32, 32) for c in ep.constants.values())
            assert len(ep.constants) == (1 if family == "encoder" else 2)
            nodes = [n for n in ep.graph.nodes if n.op == "call_function"
                     and n.target is torch.ops.tgi.fused_mha.default]
            assert len(nodes) == attentions
            # one causal self-attention a decoder layer
            assert sum(bool(n.args[3]) for n in nodes) == causal
            # a program moved to the meta device runs on meta inputs
            from torch.export.passes import move_to_device_pass

            moved = move_to_device_pass(ep, "meta").module()
            params = {k: v.to("meta") for k, v in export.load_infill(
                port_artifacts[family], device="cpu").params.items()}
            out = moved(params, torch.zeros((b, 32, 16), device="meta"))
            assert out.device.type == "meta" and tuple(out.shape) == (b, 32, 27)


@pytest.mark.parametrize("form", ["contiguous", "packed_qkv", "packed_kv"])
@pytest.mark.parametrize("causal", [False, True])
def test_operator_on_the_cpu_is_the_plain_version_in_the_kernel_layout(form, causal):
    rng = np.random.default_rng(3)
    b, t, h, hd = 3, 32, 4, 8

    def n(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if form == "contiguous":
        q, k, v = (n(b, h, t, hd) for _ in range(3))
    elif form == "packed_qkv":
        q, k, v = n(b, t, 3, h, hd).permute(2, 0, 3, 1, 4)
    else:
        q = n(b, t, h, hd).transpose(1, 2)
        k, v = n(b, t, 2, h, hd).permute(2, 0, 3, 1, 4)
    got = torch.ops.tgi.fused_mha(q, k, v, causal)
    assert torch.equal(got, attention.mha_reference(q, k, v, causal))
    assert torch.equal(got, attention.fused_mha(q, k, v, causal))
    assert got.stride() == attention.fused_mha(q, k, v, causal).stride()
    # the fake implementation gives the real layout's strides
    fake = attention._fused_mha_fake(q, k, v, causal)
    assert fake.shape == got.shape and fake.stride() == got.stride()


def test_only_a_traced_forward_calls_the_operator(weights, monkeypatch, tmp_path):
    """Eager forwards call the kernel's wrapper directly (no dispatcher);
    only ``torch.export`` tracing takes the operator."""
    _jcfg, cfg, _params, sd = weights["encoder"]
    calls = []
    op = transformer.fused_mha_op
    monkeypatch.setattr(transformer, "fused_mha_op",
                        lambda *a: calls.append(1) or op(*a))
    server = InfillServer(sd, cfg, batch_sizes=(1,), device="cpu")
    server.infill(_inputs(1))
    model = transformer.build_model(dataclasses.replace(cfg, use_fused_attention=True), "cpu")
    model.load_state_dict(sd)
    model(torch.zeros(1, 32, 16))
    assert calls == []
    export.export_infill(sd, cfg, str(tmp_path / "m.tgix"), batch_sizes=(1,))
    assert len(calls) == cfg.num_encoder_layers


def test_guards_with_jax_messages(weights, port_artifacts, tmp_path):
    _jcfg, cfg, _params, sd = weights["encoder"]
    path = port_artifacts["encoder"]
    loaded = export.load_infill(path, device="cpu")
    with pytest.raises(ValueError, match="input must be"):
        loaded.predict(np.zeros((2, 16, 16), np.float32))
    bumped = str(tmp_path / "future.tgix")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(bumped, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                meta = json.loads(data)
                meta["artifact_version"] = 999
                data = json.dumps(meta)
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="version 999"):
        export.load_infill(bumped, device="cpu")
    other = str(tmp_path / "other.zip")
    with zipfile.ZipFile(other, "w") as z:
        z.writestr("hello.txt", "hi")
    with pytest.raises(ValueError, match="not an infill export artifact"):
        export.load_infill(other, device="cpu")
    # a platform the artifact was not exported for is refused, naming both
    cuda_only = export.export_infill(sd, cfg, str(tmp_path / "cuda_only.tgix"),
                                     batch_sizes=(1,), platforms=("cuda",))
    with pytest.raises(ValueError, match=r"platforms \['cuda'\].*'cpu'"):
        export.load_infill(cuda_only, device="cpu")
    with pytest.raises(ValueError, match=r"platforms \['cuda'\].*'cpu'"):
        InfillServer.from_exported(cuda_only, device="cpu")
    with pytest.raises(ValueError, match="platforms must be drawn from"):
        export.export_infill(sd, cfg, str(tmp_path / "tpu.tgix"), platforms=("cpu", "tpu"))
    with pytest.raises(ValueError, match="batch_sizes must be positive"):
        export.export_infill(sd, cfg, str(tmp_path / "zero.tgix"), batch_sizes=(0,))
    assert not os.path.exists(str(tmp_path / "zero.tgix"))


def test_no_fallback_to_the_cpu(port_artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_infill(port_artifacts["encoder"])  # the default device


def test_main_refuses_a_legacy_model_and_an_empty_directory(tmp_path):
    empty = tmp_path / "nothing"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no checkpoint found"):
        export.main(["--checkpoint", str(empty), "--out", str(tmp_path / "x.tgix")])
    with pytest.raises(SystemExit, match="legacy torch .Model checkpoints must be imported"):
        export.main(["--checkpoint", os.path.join(REPO, "demo",
                                                  "transformer_run_demo_Epoch_799.Model"),
                     "--out", str(tmp_path / "x.tgix")])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_main_exports_a_ckpt_of_either_package(weights, tmp_path, capsys, writer):
    jcfg, cfg, params, sd = weights["encoder"]
    ckpt_dir = str(tmp_path / "ckpts")
    if writer == "jax":
        from transformergrooveinfilling_tpu.train.checkpoint import save_checkpoint
        from transformergrooveinfilling_tpu.train.loop import create_train_state, make_optimizer

        state = create_train_state(jax_build_model(jcfg), jcfg, make_optimizer("sgd", 0.1),
                                   jax.random.PRNGKey(0))
        save_checkpoint(ckpt_dir, "testrun", 3, state, 1.25, config=jcfg)
        sd = state_dict_from_flax_params(jax.tree.map(np.asarray, state.params), cfg)
    else:
        from transformergrooveinfilling_tpu_torch.train import checkpoint as ckpt
        from transformergrooveinfilling_tpu_torch.train import create_train_state

        state = create_train_state(cfg, "sgd", 0.1, 0, "cpu")
        state.model.load_state_dict(sd)
        ckpt.save_checkpoint(ckpt_dir, "testrun", 3, state, 1.25, cfg)
    out = str(tmp_path / "model.tgix")
    assert export.main(["--checkpoint", ckpt_dir, "--out", out, "--batch_sizes", "1,2",
                        "--platforms", "cpu", "--thres", "0.4"]) == 0
    printed = capsys.readouterr().out
    assert "epoch 3" in printed and "loss 1.2500" in printed and "platforms cpu" in printed
    loaded = export.load_infill(out, device="cpu")
    assert loaded.batch_sizes == [1, 2] and loaded.meta["thres"] == 0.4
    x = _inputs(3)
    want = InfillServer(sd, cfg, batch_sizes=(1, 2), thres=0.4, device="cpu").infill(x)
    np.testing.assert_allclose(loaded.predict(x), want, atol=1e-5, rtol=0)


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/infill",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["hvo"]


@pytest.mark.parametrize("flags, buckets, thres", [
    ([], [1, 4], 0.4),  # unset flags: the artifact's
    (["--batch-sizes", "2", "--thres", "0.6"], [2], 0.6),
])
def test_serve_main_artifact_answers_http_like_the_direct_server(weights, tmp_path, capsys,
                                                                flags, buckets, thres):
    _jcfg, cfg, _params, sd = weights["encoder"]
    path = export.export_infill(sd, cfg, str(tmp_path / "m.tgix"), batch_sizes=(1, 4),
                                thres=0.4)
    httpd = serve.main(["--artifact", path, "--device", "cpu", "--port", "0"] + flags,
                       block=False)
    try:
        assert f"buckets {buckets}" in capsys.readouterr().out
        x = _inputs(3)
        got = np.asarray(_post(httpd.server_address[1], {"input": x.tolist()}), np.float32)
    finally:
        httpd.shutdown()
        httpd.server_close()
    want = InfillServer(sd, cfg, batch_sizes=buckets, thres=thres, device="cpu").infill(x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(SystemExit):  # exactly one of --ckpt / --artifact
        serve.main(["--artifact", path, "--ckpt", path, "--device", "cpu"])


def test_loading_a_port_artifact_needs_no_model_code(port_artifacts):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from transformergrooveinfilling_tpu_torch.export import load_infill\n"
        f"art = load_infill({port_artifacts['encdec']!r}, device='cpu')\n"
        "assert art.predict(np.zeros((3, 32, 16), np.float32)).shape == (3, 32, 27)\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('transformergrooveinfilling_tpu_torch.models', 'transformergrooveinfilling_tpu_torch"
        ".train', 'jax', 'transformergrooveinfilling_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
