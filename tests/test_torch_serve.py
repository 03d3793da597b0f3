"""Port's InfillServer against the JAX InfillServer on shared weights:
bucketing, padding, chunking and the threshold; the HTTP contract, coalescing,
the CLI's checkpoint loading, what is not ported yet, and the no-fallback
rules."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transformergrooveinfilling_tpu.models import build_model as jax_build_model
from transformergrooveinfilling_tpu.models import torch_compat as jax_torch_compat
from transformergrooveinfilling_tpu.models.transformer import (
    GrooveTransformerConfig as JaxConfig,
)
from transformergrooveinfilling_tpu.serve import InfillServer as JaxInfillServer
from transformergrooveinfilling_tpu_torch import NotPortedError
from transformergrooveinfilling_tpu_torch import serve
from transformergrooveinfilling_tpu_torch.models import GrooveTransformerConfig
from transformergrooveinfilling_tpu_torch.models.torch_compat import (
    state_dict_from_flax_params,
)
from transformergrooveinfilling_tpu_torch.serve import (
    InfillServer, MultiTaskServer, _Coalescer, latency_benchmark,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(REPO, "demo")
ARCH = dict(d_model=32, n_heads=4, dim_feedforward=16, num_encoder_layers=2,
            embedding_size_src=16)
JAX_CFG = JaxConfig(dropout=0.0, **ARCH)
CFG = GrooveTransformerConfig(dropout=0.0, **ARCH)
DEMO_FLAGS = ["--d_model", "32", "--n_heads", "4", "--dim_feedforward", "512",
              "--num_encoder_layers", "6", "--embedding_size_src", "27"]


def _jax_params(cfg, seed):
    params = jax_build_model(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, cfg.embedding_size_src)),
        deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def params():
    return _jax_params(JAX_CFG, 1)


@pytest.fixture(scope="module")
def state_dict(params):
    return state_dict_from_flax_params(params, CFG)


@pytest.fixture(scope="module")
def server(state_dict):
    return InfillServer(state_dict, CFG, batch_sizes=(1, 4), device="cpu")


def _post(port, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/infill",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("thres", [0.5, 0.3])
@pytest.mark.parametrize("n", [1, 3, 11])
def test_matches_jax_server(params, state_dict, rng, n, thres):
    """Same weights, same requests: single (T, E), padded (3 → bucket 4) and
    chunked (11 → 4 + 4 + 4 padded) answers agree with the JAX server."""
    jax_srv = JaxInfillServer(params, JAX_CFG, batch_sizes=(1, 4), thres=thres,
                              use_pallas=False)
    port_srv = InfillServer(state_dict, CFG, batch_sizes=(1, 4), thres=thres,
                            device="cpu")
    x = rng.standard_normal((n, 32, 16)).astype(np.float32)
    x = x[0] if n == 1 else x  # n == 1: the single-grid form
    want, got = jax_srv.infill(x), port_srv.infill(x)
    assert got.shape == want.shape == x.shape[:-1] + (27,)
    np.testing.assert_array_equal(got[..., :9], want[..., :9])  # thresholded hits
    np.testing.assert_allclose(got[..., 9:], want[..., 9:], atol=3e-5)


def test_buckets_padding_and_chunks(server, rng, monkeypatch):
    seen = []
    forward = server._forward
    monkeypatch.setattr(server, "_forward",
                        lambda x: seen.append(x.shape[0]) or forward(x))
    x = rng.standard_normal((11, 32, 16)).astype(np.float32)
    out = server.infill(x)
    assert seen == [4, 4, 4]
    seen.clear()
    assert server.infill(x[:3]).shape == (3, 32, 27) and seen == [4]
    seen.clear()
    assert server.infill(x[0]).shape == (32, 27) and seen == [1]
    # padding and chunking are invisible: equal to one request per item
    per_item = np.concatenate([server.infill(x[i : i + 1]) for i in range(11)])
    np.testing.assert_allclose(out, per_item, atol=1e-6)
    assert set(np.unique(out[..., :9])) <= {0.0, 1.0}


def test_unthresholded_hits_are_sigmoids(state_dict, rng):
    raw = InfillServer(state_dict, CFG, batch_sizes=(1,), use_thres=False,
                       device="cpu")
    thr = InfillServer(state_dict, CFG, batch_sizes=(1,), thres=0.3, device="cpu")
    x = rng.standard_normal((32, 16)).astype(np.float32)
    h = raw.infill(x)[..., :9]
    assert ((h > 0) & (h < 1)).all()
    np.testing.assert_array_equal(thr.infill(x)[..., :9], (h > 0.3).astype(np.float32))


def test_bad_input_raises(server):
    with pytest.raises(ValueError, match="input must be"):
        server.infill(np.zeros((5, 5), np.float32))


def test_http_contract(server, state_dict, rng):
    fresh = InfillServer(state_dict, CFG, batch_sizes=(1,), device="cpu")
    httpd = fresh.serve_http(port=0, block=False)
    port = httpd.server_address[1]
    try:
        assert httpd.request_queue_size == 128
        # a fresh server's /healthz is strict JSON: null percentiles, no NaN
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            raw = resp.read()
        assert b"NaN" not in raw
        health = json.loads(raw)
        assert health == {"ok": True, "count": 0, "p50_ms": None, "p99_ms": None}

        x = rng.standard_normal((32, 16)).astype(np.float32)
        code, payload = _post(port, {"input": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(payload["hvo"]), fresh.infill(x),
                                   atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["count"] == 2 and health["p50_ms"] > 0

        for raw_body, name in ((b"{not json", "JSONDecodeError"),
                               (b"[1, 2]", "ValueError"),
                               (json.dumps({"x": 1}).encode(), "ValueError"),
                               (json.dumps({"input": [[1.0, 2.0]]}).encode(),
                                "ValueError")):
            code, payload = _post(port, None, raw=raw_body)
            assert code == 400 and payload["error"].startswith(name), raw_body
        code, payload = _post(port, {"input": x.tolist(), "format": "midi"})
        assert code == 501 and payload["error"].startswith("NotPortedError")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_coalescing_matches_direct_under_8_threads(state_dict, rng):
    direct = InfillServer(state_dict, CFG, batch_sizes=(1, 8), device="cpu")
    coal = InfillServer(state_dict, CFG, batch_sizes=(1, 8), device="cpu",
                        coalesce=True, coalesce_wait_ms=5.0)
    xs = [rng.standard_normal((32, 16)).astype(np.float32) for _ in range(16)]
    want = [direct.infill(x) for x in xs]
    got, errs = [None] * len(xs), []

    def worker(ids):
        try:
            for i in ids:
                got[i] = coal.infill(xs[i])
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(range(j, 16, 8),))
               for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errs
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-6)
    assert coal.stats.count == len(xs)
    with pytest.raises(ValueError):  # bad input raises in the caller
        coal.infill(np.zeros((5, 5), np.float32))


def test_coalescer_failure_keeps_released_results():
    class FlakyServer:
        batch_sizes = (8,)

        def _predict_batched(self, x):
            if x.shape[0] > 1:
                raise RuntimeError("mid-distribution failure")
            return np.ones((x.shape[0], 32, 27), np.float32)

    coal = _Coalescer(FlakyServer(), max_wait_ms=30.0)
    results, errors = [], []

    def worker():
        try:
            results.append(coal.submit(np.zeros((1, 32, 16), np.float32)))
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) + len(results) == 4 and errors


def test_hvo_input(state_dict, rng):
    sym_cfg = GrooveTransformerConfig(dropout=0.0, **{**ARCH, "embedding_size_src": 27})
    sym_params = _jax_params(JaxConfig(dropout=0.0, **{**ARCH, "embedding_size_src": 27}), 4)
    sym = InfillServer(state_dict_from_flax_params(sym_params, sym_cfg), sym_cfg,
                       batch_sizes=(1,), device="cpu")
    grid = (rng.random((32, 27)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(sym.infill_from_hvo(grid), sym.infill(grid))
    with pytest.raises(ValueError, match="HVO grid"):
        sym.infill_from_hvo(grid[:, :20])

    audio = InfillServer(state_dict, CFG, batch_sizes=(1,), device="cpu")
    with pytest.raises(ValueError, match="HVO grid"):
        audio.infill_from_hvo(grid[:, :16])  # a model-space input is no grid
    # SoundFont kits are the part of hvo_input that is not ported yet
    with pytest.raises(NotPortedError, match="SoundFont"):
        audio.infill_from_hvo(grid, sf_path="kit.sf2")
    with pytest.raises(NotPortedError, match="SoundFont"):
        sym.infill_from_hvo(grid, sf_path="kit.sf2")
    httpd = audio.serve_http(port=0, block=False)
    try:
        code, payload = _post(httpd.server_address[1],
                              {"hvo_input": grid.tolist(), "sf_path": "kit.sf2"})
        assert code == 501 and "not ported" in payload["error"]
        code, payload = _post(httpd.server_address[1], {"hvo_input": grid[:, :16].tolist()})
        assert code == 400 and payload["error"].startswith("ValueError")
    finally:
        httpd.shutdown()
        httpd.server_close()


def _partial_loops(n, seed):
    """Synthetic drum loops with the hats removed: what a client sends."""
    from transformergrooveinfilling_tpu.data.synthetic import synthetic_gmd_sequences

    x = np.stack([s.hvo for s in synthetic_gmd_sequences(n, seed=seed)]).astype(np.float32)
    x[:, :, [2, 11, 20]] = 0
    return x


@pytest.mark.parametrize("qpm", [120.0, 90.0, 150.0])
def test_audio_hvo_input_matches_jax_server(params, state_dict, qpm):
    """The slice as a whole: a partial grid + tempo to an audio-width server
    on the CPU goes through the port's synth + MSO front end and the model,
    and returns what the JAX server returns on the same weights (the front
    end has no parameters: the kit and the filterbank are recomputed and
    tested equal). v/o within 1e-4; hits equal wherever the JAX sigmoid is
    not within 1e-4 of the threshold."""
    jax_srv = JaxInfillServer(params, JAX_CFG, batch_sizes=(1, 4), use_pallas=False)
    jax_raw = JaxInfillServer(params, JAX_CFG, batch_sizes=(1, 4), use_pallas=False,
                              use_thres=False)
    port_srv = InfillServer(state_dict, CFG, batch_sizes=(1, 4), device="cpu")
    grids = _partial_loops(3, seed=int(qpm))
    want = jax_srv.infill_from_hvo(grids, qpm=qpm)
    sig = jax_raw.infill_from_hvo(grids, qpm=qpm)[..., :9]
    got = port_srv.infill_from_hvo(grids, qpm=qpm)
    assert got.shape == want.shape == (3, 32, 27)
    np.testing.assert_allclose(got[..., 9:], want[..., 9:], atol=1e-4)
    sure = np.abs(sig - 0.5) >= 1e-4
    np.testing.assert_array_equal(got[..., :9][sure], want[..., :9][sure])
    # a single (T, 27) grid answers (T, 27), the same row
    one = port_srv.infill_from_hvo(grids[1], qpm=qpm)
    assert one.shape == (32, 27)
    np.testing.assert_allclose(one[:, 9:], got[1, :, 9:], atol=1e-5)
    # the tempo matters: another qpm renders another input
    other = port_srv.infill_from_hvo(grids, qpm=qpm + 37.0)
    assert np.abs(other[..., 9:] - got[..., 9:]).max() > 1e-3


def test_audio_hvo_input_over_http_matches_jax_server(params, state_dict):
    jax_srv = JaxInfillServer(params, JAX_CFG, batch_sizes=(1,), use_pallas=False)
    port_srv = InfillServer(state_dict, CFG, batch_sizes=(1,), device="cpu")
    grid = _partial_loops(1, seed=3)[0]
    httpd = port_srv.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        code, payload = _post(port, {"hvo_input": grid.tolist(), "qpm": 97})
        assert code == 200
        got = np.asarray(payload["hvo"], np.float32)
        np.testing.assert_allclose(got[:, 9:], jax_srv.infill_from_hvo(grid, qpm=97.0)[:, 9:],
                                   atol=1e-4)
        np.testing.assert_array_equal(got, port_srv.infill_from_hvo(grid, qpm=97.0))
        # no "qpm": 120, as the JAX handler
        code, payload = _post(port, {"hvo_input": grid.tolist()})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(payload["hvo"], np.float32),
                                      port_srv.infill_from_hvo(grid))
        code, payload = _post(port, {"hvo_input": grid.tolist(), "qpm": "fast"})
        assert code == 400 and payload["error"].startswith("ValueError")
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_latency_benchmark_with_hvo_input(server):
    stats = latency_benchmark(server, n_requests=3, hvo_input=True, qpm=150.0)
    assert 0 < stats["p50_ms"] <= stats["p99_ms"]
    httpd = server.serve_http(port=0, block=False)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/infill"
        count = server.stats.count
        stats = latency_benchmark(server, n_requests=2, url=url, hvo_input=True)
        assert 0 < stats["p50_ms"] and server.stats.count == count + 3
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_latency_benchmark_in_process_and_over_http(server):
    stats = latency_benchmark(server, n_requests=5)
    assert 0 < stats["p50_ms"] <= stats["p99_ms"]
    httpd = server.serve_http(port=0, block=False)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/infill"
        stats = latency_benchmark(server, n_requests=5, url=url)
        assert 0 < stats["p50_ms"] <= stats["p99_ms"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_multi_task_server(state_dict, rng):
    mts = MultiTaskServer({"InfillingRandom": (state_dict, CFG)},
                          batch_sizes=(1,), device="cpu")
    out = mts.infill("InfillingRandom", rng.standard_normal((32, 16)).astype(np.float32))
    assert out.shape == (32, 27)
    with pytest.raises(KeyError):
        mts.infill("Nope", np.zeros((32, 16), np.float32))
    httpd = mts.serve_http(port=0, block=False)
    try:
        port = httpd.server_address[1]
        code, payload = _post(port, {"experiment": "InfillingRandom",
                                     "input": np.zeros((32, 16)).tolist()})
        assert code == 200 and np.asarray(payload["hvo"]).shape == (32, 27)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["tasks"]["InfillingRandom"]["count"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_main_serves_the_demo_checkpoint_like_jax(rng, capsys):
    """``main`` loads a legacy .Model with the architecture flags and
    answers an hvo_input request as the JAX server does on the same file
    (the demo directory also holds a .ckpt, which a directory would pick)."""
    httpd = serve.main(["--ckpt", os.path.join(DEMO_DIR, "transformer_run_demo_Epoch_799.Model"),
                        "--device", "cpu", "--port", "0"] + DEMO_FLAGS, block=False)
    try:
        assert "serving" in capsys.readouterr().out
        grid = (rng.random((32, 27)) < 0.2).astype(np.float32)
        code, payload = _post(httpd.server_address[1], {"hvo_input": grid.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 200
    jax_cfg = JaxConfig(d_model=32, n_heads=4, dim_feedforward=512,
                        num_encoder_layers=6, embedding_size_src=27)
    params, _, _ = jax_torch_compat.load_legacy_checkpoint(
        os.path.join(DEMO_DIR, "transformer_run_demo_Epoch_799.Model"), jax_cfg)
    want = JaxInfillServer(params, jax_cfg, batch_sizes=(1,),
                           use_pallas=False).infill_from_hvo(grid)
    got = np.asarray(payload["hvo"], np.float32)
    np.testing.assert_array_equal(got[:, :9], want[:, :9])
    np.testing.assert_allclose(got[:, 9:], want[:, 9:], atol=3e-5)


def test_main_refuses_what_is_not_ported():
    with pytest.raises(NotPortedError, match="artifact"):
        serve.main(["--artifact", "m.tgix", "--device", "cpu"])
    # a native .ckpt is ported now: it serves (its test is below)
    httpd = serve.main(["--ckpt", os.path.join(DEMO_DIR, "transformer_run_demo_Epoch_799.ckpt"),
                        "--device", "cpu", "--port", "0"], block=False)
    httpd.shutdown()
    httpd.server_close()
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])


def test_main_serves_the_demo_ckpt_without_architecture_flags_like_jax(rng, capsys):
    """The JAX-written demo ``.ckpt`` carries its config: ``main`` serves it
    with no architecture flags and answers as the JAX server does on the
    same file."""
    from transformergrooveinfilling_tpu.train import checkpoint as jax_ckpt

    path = os.path.join(DEMO_DIR, "transformer_run_demo_Epoch_799.ckpt")
    httpd = serve.main(["--ckpt", path, "--device", "cpu", "--port", "0"], block=False)
    try:
        assert "serving" in capsys.readouterr().out
        grid = (rng.random((32, 27)) < 0.2).astype(np.float32)
        code, payload = _post(httpd.server_address[1], {"input": grid.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 200
    params, jax_cfg, _epoch, _loss = jax_ckpt.load_params_and_config(path)
    want = JaxInfillServer(params, jax_cfg, batch_sizes=(1,), use_pallas=False).infill(grid)
    got = np.asarray(payload["hvo"], np.float32)
    np.testing.assert_array_equal(got[:, :9], want[:, :9])
    np.testing.assert_allclose(got[:, 9:], want[:, 9:], atol=3e-5)


def test_no_fallback(state_dict, monkeypatch):
    with pytest.raises(ValueError, match="use_kernel=True needs a CUDA device"):
        InfillServer(state_dict, CFG, batch_sizes=(1,), use_kernel=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InfillServer(state_dict, CFG, batch_sizes=(1,), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InfillServer(state_dict, CFG, batch_sizes=(1,))  # the default device


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import transformergrooveinfilling_tpu_torch.serve\n"
        "import transformergrooveinfilling_tpu_torch.ops\n"
        "import transformergrooveinfilling_tpu_torch.train\n"
        "import transformergrooveinfilling_tpu_torch.hvo\n"
        "import transformergrooveinfilling_tpu_torch.audio\n"
        "import transformergrooveinfilling_tpu_torch.data\n"
        "import transformergrooveinfilling_tpu_torch.ops.mso\n"
        "import transformergrooveinfilling_tpu_torch.ops.band_energies\n"
        "import transformergrooveinfilling_tpu_torch.ops.device_synth\n"
        "import transformergrooveinfilling_tpu_torch.train.checkpoint\n"
        "import transformergrooveinfilling_tpu_torch.train.schedule\n"
        "import transformergrooveinfilling_tpu_torch.utils.msgpack\n"
        "import transformergrooveinfilling_tpu_torch.utils.yaml_subset\n"
        "import transformergrooveinfilling_tpu_torch.utils.logging\n"
        "import transformergrooveinfilling_tpu_torch.utils.serialization\n"
        "from transformergrooveinfilling_tpu_torch.train import load_hyperparameters\n"
        "load_hyperparameters('configs/InfillingRandom_training.yaml')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'msgpack', 'wandb', "
        "'transformergrooveinfilling_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
