"""Host streaming and device traces in the port, against the JAX package on
the CPU: ``StreamingAugmenter`` generations (symbolic bit for bit, audio
outputs bit for bit and inputs within the MSO bar), a partial generation
written in place against the full view, the regen cadence (fixed and
``"auto"``) swapping on the JAX driver's blocks for the same generation and
block times, ``run_training(streamer=...)`` on the CPU, and the
``TGI_PROFILE`` trace of the first block."""

import json
import os
import types

import numpy as np
import pytest
import torch

from transformergrooveinfilling_tpu.data.pipeline import StreamingAugmenter as JaxStreamer
from transformergrooveinfilling_tpu.train import driver as jax_driver
from transformergrooveinfilling_tpu.train.config import HyperParams as JaxHyperParams
from transformergrooveinfilling_tpu_torch.data import synthetic
from transformergrooveinfilling_tpu_torch.data.pipeline import StreamingAugmenter
from transformergrooveinfilling_tpu_torch.train import HyperParams, run_training
from transformergrooveinfilling_tpu_torch.train import driver
from transformergrooveinfilling_tpu_torch.utils import logging as xlog

HP = {"experiment": "InfillingClosedHH_Symbolic", "encoder_only": 1,
      "optimizer_algorithm": "sgd", "d_model": 16, "n_heads": 2, "dropout": 0.1,
      "num_encoder_decoder_layers": 1, "hit_loss_penalty": 0.5, "batch_size": 8,
      "dim_feedforward": 16, "learning_rate": 0.05, "epochs": 4}


def _base(n=8, seed=60):
    return np.stack([s.hvo for s in synthetic.synthetic_gmd_sequences(n, seed=seed)]).astype(
        np.float32)


def _generations(cls, count, api="next_epoch", **kw):
    with cls(**kw) as streamer:
        return [getattr(streamer, api)() for _ in range(count)]


@pytest.mark.parametrize("partial", [1, 3])
def test_symbolic_generations_equal_jax(partial):
    kw = dict(base_hvos=_base(), aug_per_item=3, mode="symbolic", seed=5, partial=partial,
              thres_range=(0.3, 0.7))
    for api in ("next_epoch", "next_epoch_delta"):
        got = _generations(StreamingAugmenter, 4, api, **kw)
        want = _generations(JaxStreamer, 4, api, **kw)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
                else:
                    assert a == b  # the delta's slice


def test_audio_generations_match_jax_within_the_mso_bar(monkeypatch):
    base = _base(4, seed=61)
    qpms = np.asarray([90.0, 100.0, 120.0, 133.0])
    kw = dict(base_hvos=base, qpms=qpms, aug_per_item=2, mode="audio", seed=9, partial=2)
    got = _generations(StreamingAugmenter, 2, "next_epoch_delta", device="cpu", **kw)
    want = _generations(JaxStreamer, 2, "next_epoch_delta", **kw)
    for (sl, g_in, g_out), (wsl, w_in, w_out) in zip(got, want):
        assert sl == wsl and np.array_equal(g_out, w_out)
        assert g_in.shape == w_in.shape == (len(w_out), 32, 16)
        np.testing.assert_allclose(g_in, w_in, atol=1e-5 * np.abs(w_in).max(), rtol=1e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingAugmenter(base, qpms=qpms, mode="audio")


def test_audio_device_route_matches_jax_where_the_host_route_moves_an_onset(monkeypatch):
    """The streaming producer's audio inputs on the card run the device route
    (f32 onsets, the JAX device route's order). Its plain versions on the CPU
    equal the JAX package's device route within the card test's bar (atol
    2e-5·max, rtol 1e-3) on that test's items: 16 grids of
    synthetic_gmd_sequences(16, seed=3), 2 augmentations each, seed 4,
    tempos 90-150. The host route (numpy mixer, f64 onsets) is another
    route: item 18 (126 qpm) has a kick at 126,004.98 samples, 126,004 in
    f64 and 126,005 in f32, which moves 13 band energies of steps 24-25 by
    up to 0.078. Both packages' routes differ there alike, so the card test
    holds the producer to the device route."""
    from transformergrooveinfilling_tpu.ops import mso as jax_mso
    from transformergrooveinfilling_tpu_torch.ops import mso

    base = np.stack([s.hvo for s in synthetic.synthetic_gmd_sequences(16, seed=3)])
    kw = dict(qpms=np.linspace(90.0, 150.0, 16), aug_per_item=2, mode="audio", seed=4)
    with StreamingAugmenter(base, device="cpu", **kw) as st:
        host_in = st.next_epoch_delta()[1]
    seen = []
    real = mso.mso_batch_from_hvo

    def device_route(hvos, sfs, qpms, **k):
        seen.append((np.array(hvos), np.array(qpms)))
        return real(hvos, sfs, qpms, **{**k, "device_synth": True})

    monkeypatch.setattr(mso, "mso_batch_from_hvo", device_route)
    with StreamingAugmenter(base, device="cpu", **kw) as st:
        _sl, got_in, _out = st.next_epoch_delta()
    hvos, qpms = seen[0]  # the first generation's (the producer runs on to the next)
    want = np.asarray(jax_mso.mso_batch_from_hvo(hvos, None, qpms, device_synth=True))
    np.testing.assert_allclose(got_in, want, atol=2e-5 * np.abs(want).max(), rtol=1e-3)
    moved = np.abs(host_in - got_in) > 2e-5 * np.abs(got_in).max() + 1e-3 * np.abs(got_in)
    assert {(int(i), int(t)) for i, t, _b in np.argwhere(moved)} == {(18, 24), (18, 25)}
    assert moved.sum() == 13 and 0.07 < np.abs(host_in - got_in).max() < 0.08
    assert qpms[18] == 126.0
    sps, off = np.float32(126.0 / 15.0), hvos[18, 24, 18]  # the kick's offset (voice 0)
    assert int((24 + float(off)) / (126.0 / 15.0) * 44100) == 126004
    assert int((np.float32(24) + off) / sps * np.float32(44100)) == 126005


def test_partial_generations_written_in_place_equal_the_full_view():
    kw = dict(base_hvos=_base(9), aug_per_item=2, mode="symbolic", seed=3, partial=3)
    full = _generations(StreamingAugmenter, 5, **kw)
    deltas = _generations(StreamingAugmenter, 5, "next_epoch_delta", **kw)
    inputs = outputs = None
    for (sl, fresh_in, fresh_out), (want_in, want_out) in zip(deltas, full):
        if sl is None:
            inputs, outputs = torch.from_numpy(fresh_in.copy()), torch.from_numpy(fresh_out.copy())
            ptr = inputs.data_ptr()
        else:
            driver._slab_update(inputs, fresh_in, sl.start)
            driver._slab_update(outputs, fresh_out, sl.start)
            assert inputs.data_ptr() == ptr  # written in place
        assert np.array_equal(inputs.numpy(), want_in) and np.array_equal(outputs.numpy(),
                                                                          want_out)


class _ScriptedStreamer:
    """A streamer whose generations take the scripted seconds: the k-th read
    of ``last_generation_seconds`` (one a block, auto cadence only) returns
    ``gen_seconds[k]``; ``swaps`` records the block each swap came before,
    read from ``clock`` (see :class:`_Clock`)."""

    def __init__(self, n, gen_seconds, clock=None):
        self.n_samples, self._gen, self.reads, self.swaps = n, list(gen_seconds), 0, []
        self.clock = clock
        rng = np.random.default_rng(0)
        h = (rng.random((n, 32, 9)) < 0.3).astype(np.float32)
        self._y = np.concatenate([h, h * 0.8, h * 0.1], 2).astype(np.float32)

    @property
    def last_generation_seconds(self):
        self.reads += 1
        return self._gen[self.reads - 1]

    def next_epoch(self, timeout=None):
        if self.clock is not None:
            self.swaps.append(self.clock.block())
        return self._y.copy(), self._y.copy()


class _Clock:
    """Each call one second later. A driver reads it once before the loop,
    then at a block's start and end, so a block takes 1 s and block k starts
    at the (2k + 2)-th call."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 1.0
        return self.now

    def block(self) -> int:
        return int(self.now - 2) // 2


@pytest.mark.parametrize("cadence, gen_seconds", [
    (3, [0.0] * 7),
    ("auto", [0.5, 3.2, 3.0, 1.5, 1.5, 0.4, 2.2, 0.2, 0.2, 0.2]),
])
def test_regen_cadence_swaps_on_the_jax_drivers_blocks(tmp_path, monkeypatch, capsys, cadence,
                                                       gen_seconds):
    """The same scripted generation times and a clock on which every block
    takes 1 s: the port swaps generations before the same blocks as the JAX
    driver and prints the same cadence changes (a rise at once, a fall after
    two blocks that agree)."""
    class _Data:
        processed_inputs = processed_outputs = np.zeros((16, 32, 27), np.float32)

    spec = dict(HP, epochs=len(gen_seconds))
    swaps, printed = {}, {}
    for name, module, run in (
            ("jax", jax_driver, lambda st: jax_driver.run_training(
                JaxHyperParams.from_dict(spec), _Data(), {}, streamer=st, regen_cadence=cadence,
                log_media=False, ckpt_dir=str(tmp_path / "jax"))),
            ("port", driver, lambda st: run_training(
                HyperParams.from_dict(spec), _Data(), {}, streamer=st, regen_cadence=cadence,
                device="cpu", ckpt_dir=str(tmp_path / "port")))):
        clock = _Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=clock.time, strftime=lambda *a: "run"))
        streamer = _ScriptedStreamer(16, gen_seconds, clock)
        capsys.readouterr()
        run(streamer)
        swaps[name] = streamer.swaps
        printed[name] = [line for line in capsys.readouterr().out.splitlines()
                         if "regen cadence" in line]
    assert swaps["port"] == swaps["jax"]
    assert printed["port"] == printed["jax"]
    if cadence == "auto":
        assert swaps["port"] == [0, 1, 4, 6, 9] and len(printed["port"]) == 4
    else:
        assert swaps["port"] == [0, 3, 6] and printed["port"] == []


def test_run_training_trains_on_a_streamer(tmp_path):
    base = _base(8, seed=62)
    with StreamingAugmenter(base, aug_per_item=2, mode="symbolic", seed=1, partial=2) as st:
        xlog.init(run_dir=str(tmp_path / "runs"))
        try:
            run_dir = xlog.run.dir
            bundle = run_training(HyperParams.from_dict(dict(HP, epochs=6)), None, {},
                                  streamer=st, regen_cadence=1, device="cpu",
                                  ckpt_dir=str(tmp_path / "ck"))
        finally:
            xlog.finish()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [line["loss"] for line in lines]
    assert [line["epoch"] for line in lines] == list(range(6)) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(line["seqs_per_sec"] > 0 for line in lines)
    assert next(bundle.model.parameters()).device.type == "cpu"


def test_streaming_argument_checks(tmp_path):
    hp = HyperParams.from_dict(HP)
    streamer = _ScriptedStreamer(16, [0.0] * 4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_training(hp, None, streamer=streamer, on_device_augment=lambda *a: a,
                     device="cpu")
    for bad in (0, "fast", 1.5):
        with pytest.raises(ValueError, match="regen_cadence"):
            run_training(hp, None, streamer=streamer, regen_cadence=bad, device="cpu")
    streamer.n_samples = 12  # generations of 16 rows
    with pytest.raises(ValueError, match="constant size"):
        run_training(hp, None, streamer=streamer, device="cpu", ckpt_dir=str(tmp_path))


def test_tgi_profile_traces_the_first_block_only(tmp_path, monkeypatch):
    """One Chrome trace under ``<run dir>/profile`` for the first block of a
    run (a resumed run's first block too), holding the step's operators;
    nothing without a run."""
    class _Data:
        processed_outputs = _base(8, seed=63)
        processed_inputs = processed_outputs

    monkeypatch.setenv("TGI_PROFILE", "1")
    hp = HyperParams.from_dict(dict(HP, epochs=3))
    run_training(hp, _Data, device="cpu", ckpt_dir=str(tmp_path / "no_run"))
    xlog.init(run_dir=str(tmp_path / "runs"))
    try:
        run_dir = xlog.run.dir
        run_training(hp, _Data, device="cpu", ckpt_dir=str(tmp_path / "ck"), initial_epoch=1)
    finally:
        xlog.finish()
    assert os.listdir(os.path.join(run_dir, "profile")) == ["trace.json"]
    with open(os.path.join(run_dir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names) and "aten::randperm" in names
    assert not os.path.exists(tmp_path / "no_run" / "profile")


def test_streaming_and_datasets_leave_the_global_torch_generator_alone(tmp_path):
    """The port draws from its own generators: building a dataset, streaming
    and training move nothing of torch's process-global generator, on which
    the reference tests' torch oracles draw their weights."""
    from transformergrooveinfilling_tpu_torch.data import datasets

    state = torch.random.get_rng_state()
    seqs = synthetic.synthetic_gmd_sequences(6, seed=64)
    datasets.GrooveMidiDatasetInfillingRandom(data=seqs, device="cpu", max_aug_items=2,
                                              seed=1, save=False)
    with StreamingAugmenter(_base(8), aug_per_item=2, seed=1, partial=2) as st:
        run_training(HyperParams.from_dict(dict(HP, epochs=2)), None, streamer=st,
                     device="cpu", ckpt_dir=str(tmp_path))
    assert torch.equal(state, torch.random.get_rng_state())
