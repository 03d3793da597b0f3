"""On-device drum-loop synthesis: HVO events → waveform, on the card.

Replaces the Pallas TPU kernel ``transformergrooveinfilling_tpu/ops/
device_synth.py::_synth_pallas`` (kernel body ``_synth_kernel``). Synthesis is
a sum of velocity-scaled, time-shifted samples — linear in the events:

    HVO grid (M, T, 3V)  →  one event per cell (onset, table row, gain; 288)
    →  out[onset_e : onset_e + S] += gain_e · table[row_e], in cell order
    →  (M, L) float32 waveforms, resident for the MSO DSP

Every cell is an event, hit or not (a cell without a hit has gain 0 and is
skipped), so shapes are static. The kernel is ``csrc/device_synth.cu``: a
block owns a tile of one item's output samples and sums the events that
overlap it, in order, in registers — each sample is written once, nothing is
atomic, reruns are bit-identical. :func:`synth_events_plain` is the same sum
in plain PyTorch (a loop over the cells of scatter-adds, the counterpart of
the JAX package's scan); the kernel rounds the product and the sum separately
and equals it bit for bit.

What bounds it on the H100: memory — the waveforms written once (47 MB for 64
loops at 120 bpm), and, since every (event, sample) pair reads one value of
the 2.2 MB sample table, some 420 MB of L2 reads for the same 64 loops, which
no tiling shares. The tile is chosen here (:func:`samples_per_thread`): 512
samples a block for one loop, so the grid covers the card; 4,096 for a chunk
of 64 or 256, so a block reads its item's events once per 16 KB of output.
Inside a block the events are read 4 at a time and kept by one block-wide
scan; the table loads of 4 or 8 kept events are issued before their adds. On
an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 10; PERF.md §6)
one loop at 120 bpm takes 4.3 µs of device time, 64 loops 65 µs and 256
loops 215 µs, against 0.9, 14.8 and 57 µs of bytes bound; one ``index_add_``
over prepared indices takes 7.3, 826 and 3,349 µs.

Limits, derived for this card rather than carried over: the TPU kernel pads
every sample to a multiple of 128 lanes and caps a call at 64 items by its
scalar-memory budget. Here the table rows are as long as the longest sample
and no longer (threads read single floats), a block keeps ``lengths`` and the
events that overlap its tile in shared memory (``4·(rows + 4·events)`` bytes,
4.6 KB at 9 rows and 288 cells; up to 48 KB), and a call takes up to 65,535
items (``gridDim.y``). ``chunk_size`` therefore only bounds memory: a chunk
holds its waveforms (``4·L`` bytes per item, 0.74 MB at 120 bpm) and its
windowed frames (``4·1024`` bytes per frame, 1.7 MB per item; 312 MB peak for
a chunk of 64). The default, :data:`DEFAULT_CHUNK` = 256, is the fastest of
64, 128 and 256 measured on an NVIDIA H100 80GB HBM3 at 700 W over 512 loops
at 120 bpm (kernel route 21,900 / 26,300–27,100 / 30,100–30,300 loops/s;
PERF.md): the ~70 eager launches around the two kernels are paid once per
chunk.

Numerics follow the JAX device route: onsets in f32, in the same expression
order, truncated; velocities rounded half to even. The host mixer
(``audio/synth.py``) computes onsets in f64, so an onset may differ by one
sample where the f32 value crosses an integer.

On CPU tensors :func:`synthesize_on_device` runs the plain version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import require_device
from . import _build

DEFAULT_CHUNK = 256        # items per front-end call (see the module docstring)
MAX_ITEMS = 65535          # gridDim.y
MAX_SMEM = 48 * 1024       # dynamic shared memory without opting in: lengths + 16 B an event

_table_cache: dict = {}


def pack_tables(sf_paths, sr: int = 44100, s_max: int | None = None, device="cuda"):
    """Build the device-resident sample table for a set of kits.

    Returns ``(table, base, luts, sf_index, lengths)``: ``table`` is
    ``(R, S_max)`` float32 (every kit's flat samples, zero-padded to the
    longest), ``base`` maps kit → row offset of its first sample, ``luts`` is
    ``(K, V, 128)`` int32 mapping (kit, voice, MIDI velocity) → local table
    row, ``sf_index`` maps kit → its ``luts`` index, and ``lengths`` is
    ``(R,)`` int32, each row's true sample count (the kernel stops there).
    Cached per (kits, sr, s_max, device), so callers pay the pack and the
    transfer once. Only the procedural kit (``None``) is ported.
    """
    from ..audio.drumkit import kit_layers
    from ..audio.synth import _sample_table

    device = require_device(device, "pack_tables")
    unique = list(dict.fromkeys(sf_paths))
    key = (tuple(unique), sr, s_max, device)
    if key in _table_cache:
        return _table_cache[key]
    layered = {sf: kit_layers(_sample_table(sf, sr)) for sf in unique}
    if s_max is None:
        s_max = max((len(s) for flat, _ in layered.values() for s in flat), default=1)
    rows, lengths, base, lut_list, sf_index = [], [], {}, [], {}
    for k, sf in enumerate(unique):
        flat, lut = layered[sf]
        base[sf] = len(rows)
        sf_index[sf] = k
        lut_list.append(np.asarray(lut, np.int32))
        for s in flat:
            row = np.zeros(s_max, np.float32)
            row[: min(len(s), s_max)] = s[:s_max]
            rows.append(row)
            lengths.append(min(len(s), s_max))
    packed = np.stack(rows) if rows else np.zeros((1, s_max), np.float32)
    luts = np.stack(lut_list) if lut_list else np.zeros((1, 1, 128), np.int32)
    result = (torch.from_numpy(packed).to(device), base,
              torch.from_numpy(luts).to(device), sf_index,
              torch.tensor(lengths or [0], dtype=torch.int32, device=device))
    _table_cache[key] = result
    return result


def _extract_events(hvos, sps, sf_base, length: int, sr: float, luts=None, sf_k=None):
    """``(M, T, 3V)`` grids → flat per-cell event tensors (onset, row, gain),
    each ``(M, T·V)``. Every cell is an event; cells without a hit carry gain
    0. With ``luts`` ``(K, V, 128)`` + ``sf_k`` ``(M,)`` the sample row is
    selected by MIDI velocity through the kit's velocity-layer LUT; otherwise
    row = sf_base + voice."""
    m, t, width = hvos.shape
    v = width // 3
    h = hvos[:, :, :v].reshape(m, t * v)
    vel = hvos[:, :, v:2 * v].reshape(m, t * v)
    off = hvos[:, :, 2 * v:].reshape(m, t * v)

    cell = torch.arange(t * v, device=hvos.device)
    step = (cell // v).to(torch.float32)
    voice = cell % v

    onset = (step[None, :] + off) / sps[:, None] * sr  # f32, this order
    onset = onset.clamp(0, length - 1).to(torch.int32)  # truncates
    vel_midi = torch.round(vel * 127.0).clamp(0, 127).to(torch.int64)  # half to even
    if luts is None:
        row = sf_base[:, None] + voice[None, :]
    else:
        row = sf_base[:, None] + luts[sf_k.long()[:, None], voice[None, :], vel_midi]
    # SF2 default-modulator velocity gain: amplitude = (v/127)²
    g = vel_midi.to(torch.float32) / 127.0
    gain = torch.where(h > 0, g * g, torch.zeros((), dtype=torch.float32, device=hvos.device))
    return onset, row.to(torch.int32), gain


def synth_events_plain(onset, row, gain, table, length: int) -> torch.Tensor:
    """The kernel's math in plain PyTorch: a loop over the cells, in order,
    each adding ``gain · table[row]`` at every item's onset (one scatter-add
    per cell; within a cell an item's indices are distinct, so the sum's order
    is the cells' order). Product and sum are rounded separately."""
    m, n_events = onset.shape
    s_max = table.shape[1]
    y = torch.zeros((m, length + s_max), dtype=torch.float32, device=table.device)
    span = torch.arange(s_max, device=table.device)
    live = (gain != 0).any(dim=0).tolist()  # a cell no item hits adds zeros: skipped
    for e in range(n_events):
        if live[e]:
            seg = gain[:, e, None] * table[row[:, e].long()]
            y.scatter_add_(1, onset[:, e, None].long() + span, seg)
    return y[:, :length].contiguous()


THREADS = 256  # csrc/device_synth.cu::kThreads
PER_THREAD = (2, 4, 8, 16)  # the kernel's tiles: THREADS · p samples a block


def samples_per_thread(m: int, length: int, sms: int) -> int:
    """Samples each thread of the kernel owns, so that a block's tile is
    ``THREADS`` times as many: the largest that still gives the grid (tiles ×
    items) 4 blocks an SM, else the smallest. One loop at 120 bpm takes tiles
    of 512 samples (360 blocks, the card covered); a chunk of 64 or 256 loops
    tiles of 4,096, so each block reads its item's events once per 16 KB of
    output (``chip_smoke.py`` phase 10 times every tile: this pick was the
    fastest at M 1, 64 and 256 on an H100; PERF.md §6)."""
    for p in reversed(PER_THREAD):
        if m * -(-length // (THREADS * p)) >= 4 * sms:
            return p
    return PER_THREAD[0]


def smem_bytes(n_rows: int, n_events: int) -> int:
    """A block's dynamic shared memory: ``lengths`` and its kept events (onset,
    length, row, gain)."""
    return 4 * (n_rows + 4 * n_events)


# the entry point's arguments before the stream, as ctypes declares them
SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6


@functools.cache
def _library():
    lib = _build.load_library("device_synth")
    lib.tgi_device_synth.argtypes = SIGNATURE + [ctypes.c_void_p]
    lib.tgi_device_synth.restype = ctypes.c_int
    lib.tgi_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tgi_cuda_error_string.restype = ctypes.c_char_p
    return lib


KERNEL = _build.CountedKernel(_library, "tgi_device_synth", "tgi_cuda_error_string")


def synth_events(onset, row, gain, table, lengths, length: int) -> torch.Tensor:
    """Events ``(M, E)`` (int32 onsets in ``[0, length)`` and table rows,
    float32 gains) + ``table`` ``(R, S_max)`` + ``lengths`` ``(R,)`` int32 →
    ``(M, length)`` float32 waveforms.

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`synth_events_plain`. Each kernel launch adds one to
    ``KERNEL.launches``.
    """
    tensors = (onset, row, gain, table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return synth_events_plain(onset, row, gain, table, length)
    if any(t.device != table.device for t in tensors) or table.device.type != "cuda":
        raise ValueError("device_synth kernel needs its tensors on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if (onset.dtype, row.dtype, gain.dtype, table.dtype, lengths.dtype) != (
            torch.int32, torch.int32, torch.float32, torch.float32, torch.int32):
        raise ValueError("device_synth kernel takes int32 onsets, rows and lengths and float32 "
                         f"gains and table; got {[t.dtype for t in tensors]}")
    m, n_events = onset.shape
    if not (onset.shape == row.shape == gain.shape) or table.dim() != 2 \
            or lengths.shape != table.shape[:1]:
        raise ValueError("device_synth kernel takes (M, E) events, an (R, S_max) table and (R,) "
                         f"lengths; got {[tuple(t.shape) for t in tensors]}")
    n_rows = table.shape[0]
    if not (1 <= m <= MAX_ITEMS) or n_events < 1 or length < 1 \
            or smem_bytes(n_rows, n_events) > MAX_SMEM:
        raise ValueError(f"device_synth kernel takes 1..{MAX_ITEMS} items, at least one event "
                         f"and sample, and 4·(rows + 4·events) ≤ {MAX_SMEM} bytes of shared "
                         f"memory; got M {m}, E {n_events}, R {n_rows}, length {length}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("device_synth kernel takes contiguous tensors")
    out = torch.empty((m, length), dtype=torch.float32, device=table.device)
    KERNEL.launch((onset, row, gain, table, lengths, out),
                  (m, n_events, n_rows, table.shape[1], length,
                   samples_per_thread(m, length, _build.sm_count(table.device))), table.device)
    return out


@torch.no_grad()
def synthesize_on_device(hvos: torch.Tensor, sps: torch.Tensor, table: torch.Tensor,
                         sf_base: torch.Tensor, length: int, sr: float = 44100.0,
                         luts: torch.Tensor | None = None, sf_k: torch.Tensor | None = None,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Render ``(M, T, 3V)`` grids to ``(M, length)`` waveforms on the grids'
    device.

    ``sps``: (M,) grid steps/second. ``table``: (R, S_max) packed samples.
    ``sf_base``: (M,) int row offset of each item's kit in the table.
    ``luts``/``sf_k`` (optional, from :func:`pack_tables`): velocity-layer row
    selection for layered kits; omitted = one row per voice. ``lengths``: each
    row's sample count (omitted = ``S_max`` for every row). CUDA tensors run
    the kernel (or raise), CPU tensors the plain version.
    """
    onset, row, gain = _extract_events(hvos, sps, sf_base, length, sr, luts, sf_k)
    if lengths is None:
        lengths = torch.full((table.shape[0],), table.shape[1], dtype=torch.int32,
                             device=table.device)
    return synth_events(onset.contiguous(), row.contiguous(), gain.contiguous(), table,
                        lengths, length)


@torch.no_grad()
def _front_end(hvos, sps, table, sf_base, length, n_steps, params, luts=None, sf_k=None,
               lengths=None, method=None):
    from .mso import mso_batch

    waves = synthesize_on_device(hvos, sps, table, sf_base, length, float(params.sr),
                                 luts=luts, sf_k=sf_k, lengths=lengths)
    return mso_batch(waves, sps, n_steps, params, method=method)


def mso_batch_from_hvo_device(hvos, soundfonts, qpms, params=None,
                              chunk_size: int = DEFAULT_CHUNK,
                              device="cuda", method=None) -> np.ndarray:
    """Full audio front end on ``device``: grids in, ``(M, T, n_bands)`` MSO
    out (numpy). Per chunk only the HVO grids go to the device and only the
    ``(chunk, T, 16)`` MSO comes back; the rendered waveforms never leave it.
    All chunks are queued before the first result is fetched. ``method`` is
    :func:`ops.mso.mso_batch`'s (None: the fused kernel on a CUDA device)."""
    from .mso import MSOParams, mso_waveform_length

    params = params or MSOParams()
    device = require_device(device, "mso_batch_from_hvo_device")
    hvos = np.asarray(hvos, np.float32)
    m, t = hvos.shape[0], hvos.shape[1]
    if m == 0:
        return np.zeros((0, t, params.n_bands), np.float32)
    qpms = np.asarray(qpms, np.float64)
    sfs = list(soundfonts) if soundfonts is not None else [None] * m

    table, base, luts, sf_index, lengths = pack_tables(sfs, params.sr, device=device)
    sf_base = torch.tensor([base[sf] for sf in sfs], dtype=torch.int32, device=device)
    sf_k = torch.tensor([sf_index[sf] for sf in sfs], dtype=torch.int32, device=device)
    length = mso_waveform_length(t, float((qpms.min() / 60.0) * 4.0), params)
    sps = torch.from_numpy(((qpms / 60.0) * 4.0).astype(np.float32)).to(device)
    grids = torch.from_numpy(hvos).to(device)

    pending = [_front_end(grids[s:s + chunk_size], sps[s:s + chunk_size], table,
                          sf_base[s:s + chunk_size], length, t, params, luts,
                          sf_k[s:s + chunk_size], lengths, method)
               for s in range(0, m, chunk_size)]
    return torch.cat(pending).cpu().numpy()
