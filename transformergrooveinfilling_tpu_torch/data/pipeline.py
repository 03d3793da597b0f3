"""Streaming augmentation: fresh maskings built while the device trains, as
the JAX package's ``data/pipeline.py``.

A background thread builds each generation of random maskings (and, for the
audio modality, their renders and MSO inputs) while the device trains on the
previous one. ``next_epoch()`` blocks only if the producer has fallen behind.
The draws are the JAX class's, in its order (``np.random.default_rng(seed +
generation)``), so the masks and outputs equal the JAX package's bit for bit
and the audio inputs agree within the MSO bar.

On the card the producer launches kernels (``csrc/device_synth.cu`` and
``csrc/band_energies.cu``, through ``ops/mso.py::mso_batch_from_hvo``) from
its own thread while training launches from the main thread. So the producer
runs on a ``torch.cuda.Stream`` of its own: the kernel launchers take the
calling thread's current stream, and each 2048-item slab comes back to the
host (which waits on that stream) before the next starts, so nothing the
producer leaves on the card is read by another stream while it is written.
``close()`` stops the producer between slabs.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .. import require_device
from ..hvo import N_VOICES


class StreamingAugmenter:
    """Per-epoch regenerated random-masking augmentation.

    Args:
        base_hvos: ``(M, T, 3V)`` clean source grids (the corpus).
        qpms: ``(M,)`` tempos (audio modality only).
        aug_per_item: augmentation fan-out per epoch (dataset size = M × fanout).
        mode: "symbolic" (inputs = masked HVO) or "audio" (inputs = MSO).
        thres_range: remove_random_events threshold range.
        soundfonts: optional list to sample per render (audio mode).
        seed: generation RNG seed (generation i uses seed + i).
        partial: amortized regeneration — each generation rebuilds only a
            rotating ``1/partial`` slice of the corpus: per-generation cost
            drops by ``partial`` while every item is still refreshed every
            ``partial`` generations. ``1`` = full regeneration.
        device: where the audio mode renders and analyses (``"cuda"``
            without CUDA raises; the symbolic mode computes on the host).
    """

    def __init__(self, base_hvos: np.ndarray, qpms=None, aug_per_item: int = 4,
                 mode: str = "symbolic", thres_range=(0.4, 0.6),
                 soundfonts=None, seed: int = 0, mso_params=None,
                 partial: int = 1, device="cuda"):
        if mode not in ("symbolic", "audio"):
            raise ValueError(f"unknown streaming mode {mode!r}; expected 'symbolic' or 'audio'")
        self.device = require_device(device, "StreamingAugmenter") if mode == "audio" else None
        self.base = np.asarray(base_hvos, np.float32)
        self.qpms = (np.asarray(qpms, np.float64) if qpms is not None
                     else np.full((len(self.base),), 120.0))
        self.aug_per_item = aug_per_item
        self.mode = mode
        self.thres_range = thres_range
        self.soundfonts = list(soundfonts) if soundfonts else [None]
        self.seed = seed
        self.mso_params = mso_params
        self.partial = max(1, int(partial))
        self.last_generation_seconds = 0.0  # drives "auto" regen cadence
        self._view = None  # consumer-side full view (next_epoch path only)
        self._generation = 0
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @property
    def n_samples(self) -> int:
        return len(self.base) * self.aug_per_item

    def _build_rows(self, rng, rows: np.ndarray):
        """Fresh (inputs, outputs) for the given flat augmented-row indices
        (flat row i masks/renders base item ``i // aug_per_item``)."""
        stacked = self.base[rows // self.aug_per_item]
        qpms = self.qpms[rows // self.aug_per_item]
        n = len(stacked)
        thres = rng.uniform(*self.thres_range, (n, 1, 1))
        h = stacked[:, :, :N_VOICES]
        remove = (rng.random(h.shape) < thres) & (h > 0)
        remove3 = np.concatenate([remove] * 3, axis=2)
        kept = np.where(remove3, 0.0, stacked)
        removed = np.where(remove3, stacked, 0.0)

        if self.mode == "symbolic":
            inputs = kept
        else:
            from ..ops.mso import MSOParams, mso_batch_from_hvo

            sfs = [self.soundfonts[i] for i in
                   rng.integers(0, len(self.soundfonts), n)]
            params = self.mso_params or MSOParams()
            # build in slabs and poll the stop flag between them, so close()
            # never has to kill a thread mid-device-call (the front end itself
            # chunks further and queues its chunks before the one fetch)
            slab = 2048
            inputs = np.zeros((n, kept.shape[1], params.n_bands), np.float32)
            for s in range(0, n, slab):
                if self._stop.is_set():
                    break
                e = min(s + slab, n)
                inputs[s:e] = mso_batch_from_hvo(
                    kept[s:e], sfs[s:e], qpms[s:e], params=params, device=self.device)
        # copy=False: both arrays are already float32 — a plain astype would
        # duplicate hundreds of MB per generation at 10k-item scale
        return (inputs.astype(np.float32, copy=False),
                removed.astype(np.float32, copy=False))

    def _build_generation(self, gen: int):
        """→ (slice_or_None, fresh_inputs, fresh_outputs).

        ``None`` slice = a full generation (gen 0, or partial == 1); else the
        fresh arrays cover only the rotating 1/partial slice — the consumer
        can apply them as a device-side delta update, transferring 1/partial
        of the bytes. The producer builds and queues ONLY the slabs — O(n/partial) work and memory per
        generation; full host views exist only for ``next_epoch`` consumers,
        reconstructed on their side."""
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed + gen)
        n = self.n_samples
        if gen == 0 or self.partial == 1:
            sl = None
            fresh_in, fresh_out = self._build_rows(rng, np.arange(n))
        else:
            s0 = (gen % self.partial) * n // self.partial
            s1 = ((gen % self.partial) + 1) * n // self.partial
            sl = slice(s0, s1)
            fresh_in, fresh_out = self._build_rows(rng, np.arange(s0, s1))
        self.last_generation_seconds = time.perf_counter() - t0
        return sl, fresh_in, fresh_out

    def _producer(self):
        gen = 0
        on_card = self.device is not None and self.device.type == "cuda"
        try:
            # a no-op context off the card
            with torch.cuda.stream(torch.cuda.Stream(self.device) if on_card else None):
                while not self._stop.is_set():
                    item = (gen,) + self._build_generation(gen)
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    gen += 1
        except BaseException as e:  # surface in next_epoch, don't die silently
            self._producer_error = e

    def _get(self, timeout: float):
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            err = getattr(self, "_producer_error", None)
            if err is not None:
                raise RuntimeError(
                    "streaming producer thread failed") from err
            raise TimeoutError(
                f"streaming producer produced nothing within {timeout}s "
                "(first audio generations can be slow on CPU — raise the "
                "timeout or shrink the corpus)") from None

    def next_epoch(self, timeout: float = 300.0):
        """→ (inputs, outputs) full arrays for the next generation; normally
        returns instantly (the producer runs one generation ahead).

        The full view is reconstructed consumer-side by patching the dequeued
        slab onto a private copy (the production driver uses
        :meth:`next_epoch_delta` and never pays this); don't mix the two
        consumption APIs on one instance — each dequeues the generation
        stream."""
        gen, sl, fresh_in, fresh_out = self._get(timeout)
        self._generation = gen
        if sl is None:
            self._view = (fresh_in, fresh_out)
        else:
            # copy-on-write: the previous generation already handed out must
            # never mutate underneath its consumer
            v_in = self._view[0].copy()
            v_out = self._view[1].copy()
            v_in[sl] = fresh_in
            v_out[sl] = fresh_out
            self._view = (v_in, v_out)
        return self._view

    def next_epoch_delta(self, timeout: float = 300.0):
        """→ (slice_or_None, fresh_inputs, fresh_outputs).

        The delta consumption API: with ``partial > 1`` only the rebuilt
        slice's arrays are returned (write them into the resident tensors in
        place and transfer 1/partial of the bytes); a
        ``None`` slice means a full generation (the first one, or
        ``partial == 1``)."""
        gen, sl, fresh_in, fresh_out = self._get(timeout)
        self._generation = gen
        return sl, fresh_in, fresh_out

    def close(self):
        self._stop.set()
        try:
            self._queue.get_nowait()
        except queue.Empty:
            pass
        # the producer polls the stop flag between build slabs and put
        # attempts, so this join completes within one slab's build time
        self._thread.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
