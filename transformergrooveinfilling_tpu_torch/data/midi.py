"""MIDI ↔ HVO conversion, as the JAX package's ``data/midi.py``, on the
standard library and numpy.

A self-contained Standard-MIDI-File reader and writer (delta-time varints,
meta tempo and time-signature events, channel voice messages) plus the grid
quantizer:

- ``parse_midi``: an SMF → its notes, tempi and time signatures; PPQ and
  SMPTE division; malformed input raises ``ValueError`` with a named cause,
  never ``IndexError`` or ``struct.error``;
- ``midi_to_hvo_sequences``: drum notes → 16th-note grid, velocity ∈ [0,1],
  offset = signed fractional-gridstep distance to the nearest gridline
  (∈ [-0.5, 0.5]), split into 2-bar (32-step) loops, one run of loops per
  tempo and meter segment;
- ``hvo_to_midi``: HVO grid → one-track SMF at the loop tempo, byte for byte
  the JAX package's;
- ``gmd_to_processed_tree``: walk a GMD-style archive (``info.csv``
  metadata) → the ``GrooveMIDI_processed_<split>/hvo_sequence_data.obj``
  layout the subsetter consumes. The pickle is written through
  ``utils/serialization.py::save_to_pickle``, under the JAX package's class
  names, so either package's subsetter reads either package's tree.
"""

from __future__ import annotations

import csv
import os
import struct

import numpy as np

from ..hvo import HVOSequence, N_VOICES, midi_note_to_voice
from ..hvo.mapping import VOICE_TO_MIDI_NOTE
from ..hvo.sequence import Metadata, Tempo, TimeSignature
from ..utils.serialization import save_to_pickle


# -- SMF reading ---------------------------------------------------------------


def _read_varlen(data: bytes, pos: int, end: int):
    """Bounded SMF variable-length quantity: clean ``ValueError`` on a
    truncated or over-long (>4 byte, per spec) varint instead of IndexError."""
    value = 0
    for i in range(4):
        if pos >= end:
            raise ValueError("truncated MIDI varint")
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos
    raise ValueError("invalid MIDI varint (more than 4 bytes)")


def parse_midi(data: bytes) -> dict:
    """→ {"division", "smpte", "notes": [(tick, channel, note, velocity)],
    "tempi": [(tick, us_per_qn)], "time_signatures": [(tick, num, den)]}.

    ``division`` is ticks/quarter for metric (PPQ) files and ``None`` for
    SMPTE-division files, which instead carry ``smpte=(frames_per_second,
    ticks_per_frame)`` — ticks are then absolute time, converted to the
    metric grid per tempo segment by :func:`midi_to_hvo_sequences`.

    Every read is bounds-checked: malformed input (truncated chunks, bogus
    varints, dangling running status) raises ``ValueError`` with a named
    cause — never IndexError/struct.error — so one corrupt file in a ~20k
    file GMD drop dies cleanly.
    """
    if len(data) < 14:
        raise ValueError("truncated MIDI header")
    if data[:4] != b"MThd":
        raise ValueError("not a Standard MIDI File")
    (hlen, _fmt, ntrks, division) = struct.unpack(">IHHH", data[4:14])
    if hlen < 6:
        raise ValueError(f"invalid MThd length {hlen}")
    pos = 6 + 8 + (hlen - 6)  # tolerate extended headers (skip extra bytes)
    smpte = None
    if division & 0x8000:  # SMPTE: high byte = negative frames/sec (2's comp)
        fps = 256 - (division >> 8)
        fps = 29.97 if fps == 29 else float(fps)  # -29 means 30 drop-frame
        ticks_per_frame = division & 0xFF
        if ticks_per_frame == 0:
            raise ValueError("SMPTE division with 0 ticks/frame")
        smpte = (fps, ticks_per_frame)
        division = None
    elif division == 0:
        raise ValueError("division of 0 ticks/quarter")
    notes, tempi, tsigs = [], [], []
    for _ in range(ntrks):
        if pos + 8 > len(data) or data[pos : pos + 4] != b"MTrk":
            raise ValueError("missing MTrk chunk")
        (tlen,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        p = pos + 8
        end = p + tlen
        if end > len(data):
            raise ValueError("truncated MTrk chunk")
        tick = 0
        running = 0
        while p < end:
            delta, p = _read_varlen(data, p, end)
            tick += delta
            if p >= end:
                raise ValueError("truncated MIDI event")
            status = data[p]
            if status & 0x80:
                p += 1
                running = status
            else:
                if not running:
                    raise ValueError("running status with no prior status byte")
                status = running
            kind = status & 0xF0
            channel = status & 0x0F
            if status == 0xFF:  # meta
                if p >= end:
                    raise ValueError("truncated meta event")
                meta_type = data[p]
                p += 1
                mlen, p = _read_varlen(data, p, end)
                if p + mlen > end:
                    raise ValueError("truncated meta payload")
                payload = data[p : p + mlen]
                p += mlen
                if meta_type == 0x51 and mlen == 3:
                    us_per_qn = int.from_bytes(payload, "big")
                    if us_per_qn == 0:
                        raise ValueError("tempo meta of 0 µs/quarter")
                    tempi.append((tick, us_per_qn))
                elif meta_type == 0x58 and mlen >= 2:
                    if payload[0] == 0 or payload[1] > 7:
                        raise ValueError(
                            f"invalid time signature {payload[0]}/2^{payload[1]}")
                    tsigs.append((tick, payload[0], 1 << payload[1]))
            elif status in (0xF0, 0xF7):  # sysex
                mlen, p = _read_varlen(data, p, end)
                if p + mlen > end:
                    raise ValueError("truncated sysex payload")
                p += mlen
            elif kind == 0x90:
                if p + 2 > end:
                    raise ValueError("truncated note-on event")
                note, vel = data[p], data[p + 1]
                p += 2
                if vel > 0:
                    notes.append((tick, channel, note, vel))
            elif kind in (0x80, 0xA0, 0xB0, 0xE0):
                if p + 2 > end:
                    raise ValueError("truncated channel event")
                p += 2
            elif kind in (0xC0, 0xD0):
                if p + 1 > end:
                    raise ValueError("truncated channel event")
                p += 1
            else:
                raise ValueError(f"unhandled MIDI status 0x{status:02x}")
        pos = end
    return {"division": division, "smpte": smpte, "notes": notes,
            "tempi": tempi, "time_signatures": tsigs}


def _tempo_meter_segments(mid: dict) -> list[tuple]:
    """Split the tick axis at tempo / time-signature change points.

    → [(start_tick, end_tick, qpm, num, den)], end_tick None for the last.
    Grid positions are metric (tick-based), so a tempo change only alters the
    qpm carried by later loops; a meter change alters the bar length, so each
    segment is re-origined and gridded with its own signature instead of
    being silently mis-gridded under the first one.
    """
    changes: dict[int, list] = {}
    for tick, us_per_qn in mid["tempi"]:
        changes.setdefault(tick, [None, None])[0] = 60e6 / us_per_qn
    for tick, num, den in mid["time_signatures"]:
        changes.setdefault(tick, [None, None])[1] = (num, den)
    qpm, num, den = 120.0, 4, 4
    segments: list[list] = []
    for tick in sorted(changes):
        new_qpm, new_sig = changes[tick]
        new_qpm = qpm if new_qpm is None else new_qpm
        new_num, new_den = (num, den) if new_sig is None else new_sig
        if (new_qpm, new_num, new_den) == (qpm, num, den):
            # redundant change (restates the current state) — never a split
            # point, even before the first segment exists: a lone tempo meta
            # at tick>0 restating the defaults must not re-origin the grid
            continue
        if segments and segments[-1][0] == tick:
            segments[-1][2:] = [new_qpm, new_num, new_den]
        else:
            if segments:
                segments[-1][1] = tick
            segments.append([tick, None, new_qpm, new_num, new_den])
        qpm, num, den = new_qpm, new_num, new_den
    if not segments:
        segments = [[0, None, 120.0, 4, 4]]
    if segments[0][0] > 0:  # events before the first change use defaults
        segments.insert(0, [0, segments[0][0], 120.0, 4, 4])
    return [tuple(s) for s in segments]


def midi_to_hvo_sequences(
    path_or_bytes, *, steps_per_quarter: int = 4, bars_per_loop: int = 2,
    metadata: Metadata | None = None, drop_empty: bool = True,
) -> list[HVOSequence]:
    """Parse drum MIDI and split into fixed-length HVO loops.

    Files with mid-stream tempo or meter changes are segmented at each
    change point; every segment grids under its own (qpm, signature) and
    yields its own loops (the reference-side dataset filter then sees
    correctly-tagged sequences instead of mis-gridded ones)."""
    data = path_or_bytes
    if not isinstance(data, (bytes, bytearray)):
        with open(data, "rb") as f:
            data = f.read()
    mid = parse_midi(bytes(data))
    division = mid["division"]

    out = []
    meta = metadata or Metadata(bpm=(60e6 / mid["tempi"][0][1]
                                     if mid["tempi"] else 120.0))
    seg_id = 0
    segments = _tempo_meter_segments(mid)
    for start, end, qpm, num, den in segments:
        if division is not None:  # metric (PPQ): tempo-independent grid
            ticks_per_step = division / steps_per_quarter
        else:  # SMPTE: ticks are absolute time; the grid depends on the
            # segment's tempo (ticks/quarter = ticks/sec · 60 / qpm)
            fps, ticks_per_frame = mid["smpte"]
            ticks_per_step = (fps * ticks_per_frame * 60.0 / qpm
                              / steps_per_quarter)
        steps_per_loop = (bars_per_loop * num * (16 // den)
                          * steps_per_quarter // 4)
        if steps_per_loop <= 0:
            # denominator beyond the 16th-note grid (e.g. x/32): the loop
            # grid cannot represent it — skip the segment instead of
            # dividing by zero downstream
            seg_id += 1
            continue
        events = []
        max_step = 0
        for tick, _channel, note, vel in mid["notes"]:
            if tick < start or (end is not None and tick >= end):
                continue
            voice = midi_note_to_voice(note)
            if voice is None:
                continue
            pos = (tick - start) / ticks_per_step
            step = int(round(pos))
            offset = pos - step
            events.append((step, voice, vel / 127.0, offset))
            max_step = max(max_step, step)
        if not events and len(segments) > 1:
            seg_id += 1
            continue

        n_loops = max(1, -(-(max_step + 1) // steps_per_loop))
        grids = np.zeros((n_loops, steps_per_loop, 3 * N_VOICES))
        for step, voice, vel, off in events:
            loop, s = divmod(step, steps_per_loop)
            if loop >= n_loops:
                continue
            if grids[loop, s, voice] and grids[loop, s, voice + N_VOICES] >= vel:
                continue  # keep the loudest hit on a collision
            grids[loop, s, voice] = 1.0
            grids[loop, s, voice + N_VOICES] = vel
            grids[loop, s, voice + 2 * N_VOICES] = np.clip(off, -0.5, 0.5)

        seg_tag = "" if len(segments) == 1 else f"_seg{seg_id}"
        for i in range(n_loops):
            seq = HVOSequence(
                hvo=grids[i],
                time_signatures=[TimeSignature(numerator=num,
                                               denominator=den)],
                tempos=[Tempo(qpm=qpm)],
                metadata=Metadata(**{
                    **meta.to_dict(), "bpm": qpm,
                    "loop_id": f"{meta.loop_id or 'loop'}{seg_tag}_{i}"}),
            )
            if drop_empty and seq.is_silent():
                continue
            out.append(seq)
        seg_id += 1
    return out


# -- SMF writing ---------------------------------------------------------------


def _varlen(value: int) -> bytes:
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def hvo_to_midi(seq: HVOSequence, path: str | None = None,
                steps_per_quarter: int = 4, division: int = 480) -> bytes:
    """Render an HVO grid to a one-track SMF (drum channel 10)."""
    qpm = seq.tempos[0].qpm or 120.0
    ticks_per_step = division / steps_per_quarter
    events = []  # (tick, bytes)
    events.append((0, b"\xff\x51\x03"
                   + int(round(60e6 / qpm)).to_bytes(3, "big")))
    ts = seq.time_signatures[0]
    den_pow = max(ts.denominator.bit_length() - 1, 0)
    events.append((0, bytes([0xFF, 0x58, 0x04, ts.numerator, den_pow, 24, 8])))

    h, v, o = seq.hits, seq.velocities, seq.offsets
    for step in range(h.shape[0]):
        for voice in range(h.shape[1]):
            if h[step, voice] > 0:
                tick = int(round((step + o[step, voice]) * ticks_per_step))
                vel = int(np.clip(round(v[step, voice] * 127), 1, 127))
                note = VOICE_TO_MIDI_NOTE[voice]
                events.append((max(tick, 0), bytes([0x99, note, vel])))
                events.append((max(tick, 0) + int(ticks_per_step // 2),
                               bytes([0x89, note, 0])))
    events.sort(key=lambda e: e[0])

    track = b""
    prev = 0
    for tick, payload in events:
        track += _varlen(tick - prev) + payload
        prev = tick
    track += _varlen(0) + b"\xff\x2f\x00"

    blob = (b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
            + b"MTrk" + struct.pack(">I", len(track)) + track)
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


# -- GMD archive → processed tree ---------------------------------------------


def gmd_to_processed_tree(gmd_root: str, out_root: str,
                          info_csv: str = "info.csv",
                          bars_per_loop: int = 2) -> dict:
    """Convert a Groove-MIDI-Dataset archive into the
    ``GrooveMIDI_processed_<split>/hvo_sequence_data.obj`` layout
    (+ metadata.csv) that :class:`..data.subsetter.GrooveMidiSubsetter` reads.

    Returns {split: n_sequences}.
    """
    info_path = os.path.join(gmd_root, info_csv)
    with open(info_path, newline="") as f:
        rows = list(csv.DictReader(f))

    per_split: dict[str, list] = {}
    for row in rows:
        midi_rel = row.get("midi_filename", "")
        midi_path = os.path.join(gmd_root, midi_rel)
        if not midi_rel or not os.path.exists(midi_path):
            continue
        style = row.get("style", "")
        meta = Metadata(
            drummer=row.get("drummer", ""),
            session=row.get("session", ""),
            master_id=f"{row.get('drummer', '')}/{row.get('session', '')}/"
                      f"{row.get('id', '')}",
            style_primary=style.split("/")[0],
            style_secondary="/".join(style.split("/")[1:]),
            beat_type=row.get("beat_type", ""),
            loop_id=row.get("id", ""),
            bpm=float(row.get("bpm", 0) or 0),
        )
        split = row.get("split", "train")
        try:
            seqs = midi_to_hvo_sequences(
                midi_path, bars_per_loop=bars_per_loop, metadata=meta)
        except (ValueError, struct.error, IndexError):
            # IndexError: truncated file (varint/chunk read past the end) —
            # one corrupt .mid must not abort the whole archive conversion
            continue
        per_split.setdefault(split, []).extend(seqs)

    counts = {}
    for split, seqs in per_split.items():
        out_dir = os.path.join(out_root, f"GrooveMIDI_processed_{split}")
        os.makedirs(out_dir, exist_ok=True)
        save_to_pickle(seqs, os.path.join(out_dir, "hvo_sequence_data.obj"))
        with open(os.path.join(out_dir, "metadata.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(
                seqs[0].metadata.to_dict()) if seqs else ["master_id"])
            writer.writeheader()
            for s in seqs:
                writer.writerow(s.metadata.to_dict())
        counts[split] = len(seqs)
    return counts
