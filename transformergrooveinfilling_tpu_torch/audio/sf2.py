"""SoundFont 2 (.sf2) reader → per-voice drum sample table, as the JAX
package's ``audio/sf2.py``.

The reference renders every loop through fluidsynth with .sf2 drum kits
(fluidsynth 2.2.6; the dataset's ``sf_path`` argument). This is a
self-contained reader of the SF2 format's RIFF structure (spec: SoundFont
2.01) that resolves, for each of the 9 HVO voices' representative
General-MIDI percussion keys, the sample a percussion preset maps to — sample
pool extraction, root-key pitch shift, and sample-rate conversion through the
native linear resampler (``native_binding.py``).

Two differences from the JAX package's copy, both repairs:

- **Tremolo sign.** The modulation LFO's volume routing (generator 13) adds
  ``val·depth`` centibels of *gain*, ``10 ** (+val·depth/200)``, as the SF2
  spec and fluidsynth have it; the JAX copy inverts the sign. So a kit here
  at depth ``+d`` equals the JAX package's at ``-d``, bit for bit.
- **No scipy.** The static filter and the swept filter both run the native
  biquad; the swept one block by block (64 samples) with the section's state
  carried through the call. Where no ``g++`` is found, the numpy versions of
  ``native_binding.py`` run instead, with the same bits.

Generator model (SF2 spec 2.01 §8.1), per instrument zone:

- keyRange (43) / velRange (44): zone selection. Zones overlapping in
  velocity *stack* (all matching zones sound simultaneously, as in
  fluidsynth); velocity-split kits select different layers per velocity.
- overridingRootKey (58) / sample pitch correction: pitch shift through the
  native linear resampler.
- initialAttenuation (48): per-zone gain ``10^(-cB/200)``; kit
  normalization is uniform across all zones so inter-zone level
  relationships survive (per-sample re-normalization would erase them).
- sampleModes (54): looped samples (modes 1/3) unroll their loop to a
  bounded one-shot render — a synthetic note-off at ``_MAX_LOOP_SECONDS``
  followed by the volume envelope's release ramp (one-shot drum rendering
  has no MIDI note-off to honor).
- volume envelope (33-38): delay/attack/hold/decay/sustain/release.
  Generator *defaults* (-12000 timecents ≈ 1 ms) are treated as
  instantaneous so unspecified envelopes are exactly identity.
- a first zone without a sampleID is the instrument's global zone (spec
  §7.7) and seeds the other zones' generator defaults.
- preset zones (§7.3): each preset zone's keyRange/velRange gates which
  notes reach its instrument; preset zones stack, and a note sounds only
  where both the preset-zone and instrument-zone ranges cover it
  (multi-instrument banks route keys to the right instrument). Preset-level
  *relative value* generators (§9.4) are honored for the modeled set —
  attenuation, filter fc/Q, pan and the volume envelope add their preset
  deltas to the instrument-zone values (``_zone_plus_preset``).
- the concave velocity→attenuation default modulator (spec §8.4.2) is
  applied at mix time — it collapses to an exact (v/127)² amplitude law
  (see audio/synth.py::velocity_gain for the derivation against
  fluidsynth 2.2.6's fluid_conv.c).
- initialFilterFc (8) / initialFilterQ (9): fluidsynth's two-pole voice
  lowpass (fluid_iir_filter.c — fc in absolute cents through fluid_ct2hz,
  Q in cB with the 1/sqrt(q) gain compensation), run per rendered zone
  through the native biquad (:func:`lowpass_coeffs`). The spec default
  (13500 cents ≈ 19.9 kHz, Q 0) is treated as bypass so unspecified
  filters stay exactly identity.
- pan (17): mono equal-power downmix normalized to 1.0 at center
  (:func:`_pan_mono_gain`) — hard-panned zones land at 1/√2, and
  stereo-sample L/R zone pairs (the spec's stereo encoding: both linked
  samples referenced by sibling zones panned ±500) sum to ≈ the centered
  mono level, which is the picture the (mono) MSO input sees.

- modulation envelope → filter cutoff (gens 25-30 + modEnvToFilterFc 11):
  the DAHDSR envelope sweeps fc(t) = initialFilterFc + modEnvToFilterFc ·
  env(t), coefficients updated per 64-sample block with biquad state
  carried (fluidsynth's per-block filter update) — the "filter snap" that
  shapes percussion transients.
- LFO routing (gens 21-24 + 5/6/10/13): fluid_lfo's delayed triangle,
  routed to volume (tremolo, a gain in cB), filter cutoff (summed into
  the same fc(t) sweep), and pitch (vibrato — variable-rate resampling,
  ``_resample_varying``).

Out of scope (documented deviation from full fluidsynth): NON-DEFAULT
modulators (the ``pmod``/``imod`` modulator lists; the default modulator
set is implemented via the generators above).
"""

from __future__ import annotations

import dataclasses
import functools
import struct

import numpy as np

from ..hvo.mapping import VOICE_TO_MIDI_NOTE
from . import native_binding
from .drumkit import DrumKit

# SF2 generator opcodes used
_GEN_INITIAL_FILTER_FC = 8
_GEN_INITIAL_FILTER_Q = 9
_GEN_PAN = 17
_GEN_INSTRUMENT = 41
_GEN_KEY_RANGE = 43
_GEN_VEL_RANGE = 44
_GEN_INITIAL_ATTENUATION = 48
_GEN_OVERRIDING_ROOT_KEY = 58
_GEN_SAMPLE_ID = 53
_GEN_SAMPLE_MODES = 54
_GEN_DELAY_VOL_ENV = 33
_GEN_ATTACK_VOL_ENV = 34
_GEN_HOLD_VOL_ENV = 35
_GEN_DECAY_VOL_ENV = 36
_GEN_SUSTAIN_VOL_ENV = 37
_GEN_RELEASE_VOL_ENV = 38
# modulation envelope (spec §8.1.2 gens 25-30) + its filter routing (11)
_GEN_MOD_ENV_TO_FILTER_FC = 11
_GEN_DELAY_MOD_ENV = 25
_GEN_ATTACK_MOD_ENV = 26
_GEN_HOLD_MOD_ENV = 27
_GEN_DECAY_MOD_ENV = 28
_GEN_SUSTAIN_MOD_ENV = 29
_GEN_RELEASE_MOD_ENV = 30
# LFOs (spec §8.1.2 gens 21-24) + their routings (5/6/10/13)
_GEN_MOD_LFO_TO_PITCH = 5
_GEN_VIB_LFO_TO_PITCH = 6
_GEN_MOD_LFO_TO_FILTER_FC = 10
_GEN_MOD_LFO_TO_VOLUME = 13
_GEN_DELAY_MOD_LFO = 21
_GEN_FREQ_MOD_LFO = 22
_GEN_DELAY_VIB_LFO = 23
_GEN_FREQ_VIB_LFO = 24

# synthetic note-off for looped samples (no MIDI note-off in one-shot
# rendering); the release ramp then bounds the render
_MAX_LOOP_SECONDS = 2.0
# render cutoff: treat the envelope as silent below -96 dB
_CUTOFF_CB = 960.0


class SF2Error(ValueError):
    pass


def _read_chunks(data: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for RIFF subchunks."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def parse_sf2(path: str) -> dict:
    """Parse the chunks needed for drum rendering → dict of tables."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"sfbk":
        raise SF2Error(f"not a SoundFont file: {path}")

    smpl = None
    pdta = {}
    for fourcc, off, size in _read_chunks(data, 12, len(data)):
        if fourcc != b"LIST":
            continue
        list_type = data[off : off + 4]
        for sub4, soff, ssize in _read_chunks(data, off + 4, off + size):
            if list_type == b"sdta" and sub4 == b"smpl":
                smpl = np.frombuffer(data, dtype="<i2", count=ssize // 2,
                                     offset=soff)
            elif list_type == b"pdta":
                pdta[sub4.decode("ascii", "replace")] = data[soff : soff + ssize]
    if smpl is None or "phdr" not in pdta:
        raise SF2Error(f"missing sdta/pdta chunks in {path}")

    phdr = [
        struct.unpack_from("<20sHHHIII", pdta["phdr"], i)
        for i in range(0, len(pdta["phdr"]) - 38, 38)  # last record is EOP
    ]
    pbag = [struct.unpack_from("<HH", pdta["pbag"], i)
            for i in range(0, len(pdta["pbag"]), 4)]
    pgen = [struct.unpack_from("<Hh", pdta["pgen"], i)
            for i in range(0, len(pdta["pgen"]), 4)]
    inst = [struct.unpack_from("<20sH", pdta["inst"], i)
            for i in range(0, len(pdta["inst"]), 22)]
    ibag = [struct.unpack_from("<HH", pdta["ibag"], i)
            for i in range(0, len(pdta["ibag"]), 4)]
    igen = [struct.unpack_from("<Hh", pdta["igen"], i)
            for i in range(0, len(pdta["igen"]), 4)]
    shdr = [
        struct.unpack_from("<20sIIIIIBbHH", pdta["shdr"], i)
        for i in range(0, len(pdta["shdr"]) - 46, 46)  # last record is EOS
    ]
    return {
        "smpl": smpl, "phdr": phdr, "pbag": pbag, "pgen": pgen,
        "inst": inst, "ibag": ibag, "igen": igen, "shdr": shdr,
    }


@dataclasses.dataclass
class _PresetZone:
    """A preset zone's instrument + selection ranges (spec §7.3/§8.5: the
    preset-level keyRange/velRange gate which notes reach the instrument —
    fluidsynth only sounds a voice when BOTH the preset zone's and the
    instrument zone's ranges cover the note) + its *relative value*
    generators (spec §9.4: a value generator at preset level is ADDED to
    the instrument-level value — ``rel`` maps generator oper → delta for
    the modeled set: attenuation, filter fc/Q, pan, volume envelope)."""

    instrument: int
    key_lo: int = 0
    key_hi: int = 127
    vel_lo: int = 0
    vel_hi: int = 127
    rel: dict = dataclasses.field(default_factory=dict)


def _preset_zones(sf: dict, bank_preference=(128, 0)) -> list[_PresetZone]:
    """Preset zones of the first percussion preset found (bank 128
    preferred, else bank 0), carrying each zone's key/vel ranges. A first
    zone without an instrument generator is the preset's global zone and
    seeds the other zones' ranges (spec §7.3)."""
    for want_bank in bank_preference:
        for p_idx, (name, preset, bank, bag_ndx, *_rest) in enumerate(
                sf["phdr"]):
            if bank != want_bank:
                continue
            next_bag = (sf["phdr"][p_idx + 1][3] if p_idx + 1 < len(sf["phdr"])
                        else len(sf["pbag"]))
            zones: list[_PresetZone] = []
            global_ranges = (0, 127, 0, 127)
            global_rel: dict = {}
            for bag in range(bag_ndx, next_bag):
                gen_start = sf["pbag"][bag][0]
                gen_end = (sf["pbag"][bag + 1][0] if bag + 1 < len(sf["pbag"])
                           else len(sf["pgen"]))
                ranges = list(global_ranges)
                # global-zone gens apply unless the zone sets that gen itself
                # (spec §7.3) — at preset level the zone's own value REPLACES
                # the global one; the preset→instrument relation is the
                # additive one
                rel = dict(global_rel)
                instrument = None
                for oper, amount in sf["pgen"][gen_start:gen_end]:
                    if oper == _GEN_KEY_RANGE:
                        raw = amount & 0xFFFF
                        ranges[0], ranges[1] = raw & 0xFF, (raw >> 8) & 0xFF
                    elif oper == _GEN_VEL_RANGE:
                        raw = amount & 0xFFFF
                        ranges[2], ranges[3] = raw & 0xFF, (raw >> 8) & 0xFF
                    elif oper in _PRESET_REL_FIELDS:
                        rel[oper] = amount
                    elif oper == _GEN_INSTRUMENT:
                        # genAmount is a union: instrument IDs are unsigned
                        # words, but the record parses as signed (value
                        # generators need the sign) — reinterpret
                        instrument = amount & 0xFFFF
                if instrument is not None:
                    zones.append(_PresetZone(instrument, *ranges, rel=rel))
                elif bag == bag_ndx:
                    global_ranges = tuple(ranges)
                    global_rel = rel
            if zones:
                return zones
    raise SF2Error("no percussion (bank 128) or default preset found")


@dataclasses.dataclass
class _Zone:
    key_lo: int = 0
    key_hi: int = 127
    vel_lo: int = 0
    vel_hi: int = 127
    root: int | None = None
    sample_id: int | None = None
    atten_cb: int = 0
    sample_modes: int = 0
    # voice lowpass (fluidsynth fluid_iir_filter): absolute cents / cB.
    # 13500 cents ≈ 19.9 kHz — the spec default, treated as bypass
    filter_fc: int = 13500
    filter_q_cb: int = 0
    # pan, -500 (hard left) .. +500 (hard right); rendered mono via an
    # equal-power downmix normalized to 1.0 at center
    pan: int = 0
    # modulation envelope (gens 25-30; sustain in 0.1 % decrease units) and
    # its cents contribution to the filter cutoff at peak (gen 11)
    mod_env_to_filter_fc: int = 0
    delay_modenv_tc: int = -12000
    attack_modenv_tc: int = -12000
    hold_modenv_tc: int = -12000
    decay_modenv_tc: int = -12000
    sustain_modenv: int = 0
    release_modenv_tc: int = -12000
    # LFOs (gens 21-24: delay in timecents; freq in absolute cents, 0 ≈
    # 8.176 Hz) and their routing depths (pitch/filter in cents, volume cB)
    delay_modlfo_tc: int = -12000
    freq_modlfo: int = 0
    delay_viblfo_tc: int = -12000
    freq_viblfo: int = 0
    mod_lfo_to_pitch: int = 0
    vib_lfo_to_pitch: int = 0
    mod_lfo_to_filter_fc: int = 0
    mod_lfo_to_volume: int = 0
    # volume envelope, raw generator units (timecents; sustain in cB)
    delay_tc: int = -12000
    attack_tc: int = -12000
    hold_tc: int = -12000
    decay_tc: int = -12000
    sustain_cb: int = 0
    release_tc: int = -12000


_ENV_GEN_FIELDS = {
    _GEN_DELAY_VOL_ENV: "delay_tc",
    _GEN_ATTACK_VOL_ENV: "attack_tc",
    _GEN_HOLD_VOL_ENV: "hold_tc",
    _GEN_DECAY_VOL_ENV: "decay_tc",
    _GEN_SUSTAIN_VOL_ENV: "sustain_cb",
    _GEN_RELEASE_VOL_ENV: "release_tc",
    _GEN_MOD_ENV_TO_FILTER_FC: "mod_env_to_filter_fc",
    _GEN_DELAY_MOD_ENV: "delay_modenv_tc",
    _GEN_ATTACK_MOD_ENV: "attack_modenv_tc",
    _GEN_HOLD_MOD_ENV: "hold_modenv_tc",
    _GEN_DECAY_MOD_ENV: "decay_modenv_tc",
    _GEN_SUSTAIN_MOD_ENV: "sustain_modenv",
    _GEN_RELEASE_MOD_ENV: "release_modenv_tc",
    _GEN_DELAY_MOD_LFO: "delay_modlfo_tc",
    _GEN_FREQ_MOD_LFO: "freq_modlfo",
    _GEN_DELAY_VIB_LFO: "delay_viblfo_tc",
    _GEN_FREQ_VIB_LFO: "freq_viblfo",
    _GEN_MOD_LFO_TO_PITCH: "mod_lfo_to_pitch",
    _GEN_VIB_LFO_TO_PITCH: "vib_lfo_to_pitch",
    _GEN_MOD_LFO_TO_FILTER_FC: "mod_lfo_to_filter_fc",
    _GEN_MOD_LFO_TO_VOLUME: "mod_lfo_to_volume",
}


# preset-level relative value generators honored (spec §9.4) — the modeled
# value-generator set (both envelopes + filter/pan/attenuation); preset
# deltas ADD to the instrument-zone value
_PRESET_REL_FIELDS = {
    _GEN_INITIAL_FILTER_FC: "filter_fc",
    _GEN_INITIAL_FILTER_Q: "filter_q_cb",
    _GEN_PAN: "pan",
    _GEN_INITIAL_ATTENUATION: "atten_cb",
    **_ENV_GEN_FIELDS,
}


def _zone_plus_preset(zone: _Zone, rel: dict) -> _Zone:
    """Instrument zone with a preset zone's relative value generators added
    (spec §9.4: preset value generators are deltas on the instrument level)."""
    if not rel:
        return zone
    return dataclasses.replace(zone, **{
        _PRESET_REL_FIELDS[oper]:
            getattr(zone, _PRESET_REL_FIELDS[oper]) + delta
        for oper, delta in rel.items() if oper in _PRESET_REL_FIELDS})


def _apply_gen(zone: _Zone, oper: int, amount: int) -> None:
    if oper == _GEN_KEY_RANGE:
        raw = amount & 0xFFFF
        zone.key_lo, zone.key_hi = raw & 0xFF, (raw >> 8) & 0xFF
    elif oper == _GEN_VEL_RANGE:
        raw = amount & 0xFFFF
        zone.vel_lo, zone.vel_hi = raw & 0xFF, (raw >> 8) & 0xFF
    elif oper == _GEN_OVERRIDING_ROOT_KEY:
        zone.root = amount
    elif oper == _GEN_INITIAL_ATTENUATION:
        zone.atten_cb = amount
    elif oper == _GEN_INITIAL_FILTER_FC:
        zone.filter_fc = amount
    elif oper == _GEN_INITIAL_FILTER_Q:
        zone.filter_q_cb = amount
    elif oper == _GEN_PAN:
        zone.pan = amount
    elif oper == _GEN_SAMPLE_MODES:
        zone.sample_modes = amount & 0xFFFF
    elif oper in _ENV_GEN_FIELDS:
        setattr(zone, _ENV_GEN_FIELDS[oper], amount)
    elif oper == _GEN_SAMPLE_ID:
        zone.sample_id = amount & 0xFFFF  # unsigned word (ID, not value)


def _zones_for_instrument(sf: dict, inst_idx: int) -> list[_Zone]:
    """All zones of an instrument, with a leading global zone (first zone
    without a sampleID, spec §7.7) applied as the others' defaults."""
    bag_start = sf["inst"][inst_idx][1]
    bag_end = (sf["inst"][inst_idx + 1][1] if inst_idx + 1 < len(sf["inst"])
               else len(sf["ibag"]))
    zones: list[_Zone] = []
    global_zone: _Zone | None = None
    for bag in range(bag_start, bag_end):
        gen_start = sf["ibag"][bag][0]
        gen_end = (sf["ibag"][bag + 1][0] if bag + 1 < len(sf["ibag"])
                   else len(sf["igen"]))
        zone = (dataclasses.replace(global_zone) if global_zone is not None
                else _Zone())
        for oper, amount in sf["igen"][gen_start:gen_end]:
            _apply_gen(zone, oper, amount)
        if zone.sample_id is not None:
            zones.append(zone)
        elif bag == bag_start:
            global_zone = zone
    return zones


def _timecents_to_seconds(tc: int) -> float:
    """Envelope time. The generator default (-12000 tc ≈ 1 ms) is treated as
    instantaneous so unspecified envelopes stay exactly identity; explicit
    values use the spec formula 2^(tc/1200), capped at 20 s."""
    if tc <= -12000:
        return 0.0
    return min(2.0 ** (tc / 1200.0), 20.0)


def _envelope(zone: _Zone, n: int, sr: int,
              note_off_s: float | None) -> np.ndarray | None:
    """One-shot volume envelope over ``n`` samples; None means identity."""
    delay = _timecents_to_seconds(zone.delay_tc)
    attack = _timecents_to_seconds(zone.attack_tc)
    hold = _timecents_to_seconds(zone.hold_tc)
    decay = _timecents_to_seconds(zone.decay_tc)
    sustain_cb = float(np.clip(zone.sustain_cb, 0, 1440))
    release = _timecents_to_seconds(zone.release_tc)
    if (delay == attack == hold == 0.0 and sustain_cb == 0.0
            and note_off_s is None):
        # sustain at 0 cB makes the decay phase a no-op whatever its time
        return None  # identity: nothing to apply
    t = np.arange(n, dtype=np.float64) / sr
    # amplitude ramp through delay/attack (linear amplitude, as fluidsynth)
    if attack > 0:
        amp = np.clip((t - delay) / attack, 0.0, 1.0)
    else:
        amp = (t >= delay).astype(np.float64)
    # decay at 1000 cB per decay-time down to the sustain level
    cb = np.zeros(n, np.float64)
    t_dec = t - (delay + attack + hold)
    if decay > 0:
        cb = np.clip(t_dec * (1000.0 / decay), 0.0, sustain_cb)
    else:
        cb = np.where(t_dec >= 0, sustain_cb, 0.0)
    # synthetic note-off → release ramp at 1000 cB per release-time
    if note_off_s is not None:
        t_rel = t - note_off_s
        rate = (1000.0 / release) if release > 0 else np.inf
        with np.errstate(invalid="ignore"):  # 0·inf before the release: not taken
            cb = cb + np.where(t_rel > 0, t_rel * rate, 0.0)
    cb = np.minimum(cb, _CUTOFF_CB + 10.0)
    env = amp * 10.0 ** (-cb / 200.0)
    env[cb >= _CUTOFF_CB] = 0.0
    return env.astype(np.float32)


def lowpass_coeffs(fc_cents: float, q_cb: float, sr: int):
    """fluidsynth's two-pole lowpass (fluid_iir_filter.c) as a0-normalized
    biquad coefficients ``(b0, b1, b2, a1, a2)``.

    fc is in absolute cents, ``8.176 * 2^(cents/1200)`` Hz (fluid_ct2hz),
    clamped to [5 Hz, 0.45·sr]; Q is in centibels (q_dB = cB/10,
    q_lin = 10^(q_dB/20)), with fluidsynth's resonance gain compensation
    ``1/sqrt(q_lin)`` folded into the numerator so high-Q zones keep their
    passband level.
    """
    import math

    fc = 8.176 * 2.0 ** (min(float(fc_cents), 13500.0) / 1200.0)
    fc = min(max(fc, 5.0), 0.45 * sr)
    q_lin = 10.0 ** (float(np.clip(q_cb, 0, 960)) / 200.0)
    filter_gain = 1.0 / math.sqrt(q_lin)
    omega = 2.0 * math.pi * fc / sr
    sin_o, cos_o = math.sin(omega), math.cos(omega)
    alpha = sin_o / (2.0 * q_lin)
    a0_inv = 1.0 / (1.0 + alpha)
    a1 = -2.0 * cos_o * a0_inv
    a2 = (1.0 - alpha) * a0_inv
    b1 = (1.0 - cos_o) * a0_inv * filter_gain
    return (b1 * 0.5, b1, b1 * 0.5, a1, a2)


def _biquad(x: np.ndarray, coeffs, state: np.ndarray | None = None) -> np.ndarray:
    """The native biquad, or its numpy version where no ``g++`` is found."""
    if native_binding.native_available():
        return native_binding.biquad(x, *coeffs, state=state)
    return native_binding.biquad_numpy(x, *coeffs, state=state)


def _apply_lowpass(x: np.ndarray, fc_cents: float, q_cb: float,
                   sr: int) -> np.ndarray:
    return _biquad(x, lowpass_coeffs(fc_cents, q_cb, sr))


def _mod_envelope(zone: _Zone, n: int, sr: int,
                  note_off_s: float | None) -> np.ndarray:
    """Modulation envelope level in [0,1] over ``n`` samples (spec §8.1.2:
    DAHDSR, linear segments, full-scale decay/release rates as fluidsynth;
    sustain in 0.1 % *decrease* units — 0 sustains at peak)."""
    delay = _timecents_to_seconds(zone.delay_modenv_tc)
    attack = _timecents_to_seconds(zone.attack_modenv_tc)
    hold = _timecents_to_seconds(zone.hold_modenv_tc)
    decay = _timecents_to_seconds(zone.decay_modenv_tc)
    sustain = 1.0 - float(np.clip(zone.sustain_modenv, 0, 1000)) / 1000.0
    release = _timecents_to_seconds(zone.release_modenv_tc)
    t = np.arange(n, dtype=np.float64) / sr
    if attack > 0:
        level = np.clip((t - delay) / attack, 0.0, 1.0)
    else:
        level = (t >= delay).astype(np.float64)
    t_dec = t - (delay + attack + hold)
    if decay > 0:
        level = level * np.clip(1.0 - t_dec / decay, sustain, 1.0)
    else:
        level = level * np.where(t_dec >= 0, sustain, 1.0)
    if note_off_s is not None:
        t_rel = t - note_off_s
        rate = (1.0 / release) if release > 0 else np.inf
        with np.errstate(invalid="ignore"):  # 0·inf before the release: not taken
            level = np.maximum(level - np.where(t_rel > 0, t_rel * rate, 0.0), 0.0)
    return level


def _lfo(n: int, sr: int, delay_tc: int, freq_cents: int) -> np.ndarray:
    """LFO value in [-1, 1] over ``n`` samples: 0 through the delay, then a
    triangle starting at 0 rising to +1 at a quarter period (fluidsynth
    fluid_lfo). Frequency is in absolute cents (0 ≈ 8.176 Hz through
    fluid_ct2hz), clamped to fluidsynth's [0.1, 100] Hz range."""
    f = min(max(8.176 * 2.0 ** (float(freq_cents) / 1200.0), 0.1), 100.0)
    delay = _timecents_to_seconds(delay_tc)
    t = np.arange(n, dtype=np.float64) / sr
    p = np.maximum(t - delay, 0.0) * f
    return 4.0 * np.abs(np.mod(p + 0.75, 1.0) - 0.5) - 1.0


def _resample_varying(raw: np.ndarray, ratio: float,
                      cents: np.ndarray) -> np.ndarray:
    """Linear resample with a per-output-sample pitch offset in cents
    (vibrato): input position advances by ``ratio·2^(cents/1200)`` per
    output sample."""
    step = ratio * 2.0 ** (np.asarray(cents, np.float64) / 1200.0)
    pos = np.concatenate([[0.0], np.cumsum(step[:-1])])
    pos = pos[pos <= len(raw) - 1]
    return np.interp(pos, np.arange(len(raw), dtype=np.float64),
                     raw.astype(np.float64)).astype(np.float32)


def _apply_lowpass_swept(x: np.ndarray, base_fc: float, q_cb: float,
                         fc_offset: np.ndarray, sr: int,
                         block: int = 64) -> np.ndarray:
    """Time-varying lowpass: fc(t) = base_fc + fc_offset(t) cents,
    coefficients recomputed per 64-sample block (fluidsynth updates its
    filter per internal block the same way), the biquad's state carried from
    block to block."""
    x = np.asarray(x, np.float32)
    y = np.empty(len(x), np.float32)
    state = np.zeros(4, np.float64)
    for s in range(0, len(x), block):
        coeffs = lowpass_coeffs(base_fc + float(fc_offset[s]), q_cb, sr)
        y[s:s + block] = _biquad(x[s:s + block], coeffs, state)
    return y


def _pan_mono_gain(pan: int) -> float:
    """Mono downmix of fluidsynth's equal-power pan law, normalized to 1.0
    at center: ``(sin((500-pan)θ) + sin((500+pan)θ)) / √2`` with
    ``θ = (π/2)/1000`` — hard-panned zones land at 1/√2, and stereo-linked
    L/R zone pairs (pan ±500) sum back to ≈ the centered level."""
    import math

    p = float(np.clip(pan, -500, 500))
    theta = math.pi / 2.0 / 1000.0
    return (math.sin((500.0 - p) * theta)
            + math.sin((500.0 + p) * theta)) / math.sqrt(2.0)


def _resample(raw: np.ndarray, ratio: float) -> np.ndarray:
    if native_binding.native_available():
        return native_binding.resample_linear(raw, ratio)
    return native_binding.resample_linear_numpy(raw, ratio)


def _render_zone(sf: dict, zone: _Zone, key: int, sr: int) -> np.ndarray | None:
    """Render one zone at ``key``: pitch-shift + loop unroll + attenuation +
    volume envelope → a bounded one-shot sample."""
    (name, start, end, loop_s, loop_e, rate, orig_pitch, pitch_corr,
     _link, _stype) = sf["shdr"][zone.sample_id]
    raw = sf["smpl"][start:end].astype(np.float32) / 32768.0
    if len(raw) < 2:
        return None
    root_key = zone.root if zone.root is not None else (
        orig_pitch if orig_pitch <= 127 else 60)
    semitones = key - root_key + pitch_corr / 100.0
    ratio = (rate / sr) * (2.0 ** (semitones / 12.0))

    ls, le = loop_s - start, loop_e - start
    looped = (zone.sample_modes & 1) and 0 <= ls < le <= len(raw) and le - ls >= 2
    note_off_s = None
    if looped:
        # unroll the loop (input domain) out to note-off + release, then cut
        note_off_s = _MAX_LOOP_SECONDS
        release_s = min(
            _timecents_to_seconds(zone.release_tc) * (_CUTOFF_CB / 1000.0),
            4.0)
        total_s = note_off_s + release_s
        need = int(total_s * sr * ratio) + 2
        if need > len(raw):
            reps = -(-(need - le) // (le - ls))
            raw = np.concatenate([raw[:le]] + [raw[ls:le]] * reps)[:need]
        else:
            raw = raw[:need]

    if zone.mod_lfo_to_pitch or zone.vib_lfo_to_pitch:
        # vibrato: per-output-sample cents from the routed LFO(s)
        n_out = max(int((len(raw) - 1) / ratio), 0)
        cents = np.zeros(n_out, np.float64)
        if zone.mod_lfo_to_pitch:
            cents += zone.mod_lfo_to_pitch * _lfo(
                n_out, sr, zone.delay_modlfo_tc, zone.freq_modlfo)
        if zone.vib_lfo_to_pitch:
            cents += zone.vib_lfo_to_pitch * _lfo(
                n_out, sr, zone.delay_viblfo_tc, zone.freq_viblfo)
        out = _resample_varying(raw, ratio, cents)
    else:
        out = _resample(raw, ratio)
    if out.size == 0:
        return None
    env = _envelope(zone, len(out), sr, note_off_s)
    if env is not None:
        out = out * env
        nz = np.flatnonzero(np.abs(out) > 1e-6)
        out = out[: int(nz[-1]) + 1] if nz.size else out[:1]
    # filter: static fc + any time-varying cents offsets (mod envelope,
    # mod LFO) summed into one fc(t) sweep
    fc_off = None
    if zone.mod_env_to_filter_fc:
        fc_off = zone.mod_env_to_filter_fc * _mod_envelope(
            zone, len(out), sr, note_off_s)
    if zone.mod_lfo_to_filter_fc:
        contrib = zone.mod_lfo_to_filter_fc * _lfo(
            len(out), sr, zone.delay_modlfo_tc, zone.freq_modlfo)
        fc_off = contrib if fc_off is None else fc_off + contrib
    if fc_off is not None:
        if fc_off.size and float(np.ptp(fc_off)) < 1e-9:
            # degenerate-constant offset (all-default mod envelope → peak
            # immediately): fold into the static filter
            out = _apply_lowpass(out, zone.filter_fc + float(fc_off[0]),
                                 zone.filter_q_cb, sr)
        else:
            out = _apply_lowpass_swept(out, zone.filter_fc, zone.filter_q_cb,
                                       fc_off, sr)
    elif zone.filter_fc < 13500 or zone.filter_q_cb > 0:
        out = _apply_lowpass(out, zone.filter_fc, zone.filter_q_cb, sr)
    if zone.mod_lfo_to_volume:
        # tremolo: the gain tracks the LFO in centibels, 10^(+val·depth/200)
        # (SF2 generator 13 and fluidsynth; the JAX copy inverts the sign)
        val = _lfo(len(out), sr, zone.delay_modlfo_tc, zone.freq_modlfo)
        out = out * (10.0 ** ((val * float(zone.mod_lfo_to_volume))
                              / 200.0)).astype(np.float32)
    gain = 1.0
    atten_cb = float(np.clip(zone.atten_cb, 0, 1440))
    if atten_cb > 0:
        gain *= 10.0 ** (-atten_cb / 200.0)
    if zone.pan:
        gain *= _pan_mono_gain(zone.pan)
    if gain != 1.0:
        out = out * np.float32(gain)
    return out


def _layers_for_key(sf: dict, preset_entries, key: int, sr: int):
    """Velocity layers for ``key``: ``(samples, lut128)`` or None.

    ``preset_entries`` is ``[(_PresetZone, [instrument _Zone, ...]), ...]``.
    Every preset zone whose keyRange covers ``key`` contributes its
    instrument's key-matching zones (preset zones stack, as in fluidsynth);
    a zone sounds at a velocity only when BOTH its own velRange and its
    preset zone's velRange cover it. Zones overlapping in velocity stack
    (their renders sum), velocity splits select different layers.
    ``lut128[v]`` indexes ``samples`` (-1 = no zone covers that velocity →
    silence)."""
    cand: list[tuple[_Zone, int, int]] = []  # (zone, eff_vel_lo, eff_vel_hi)
    for pz, zones in preset_entries:
        if not (pz.key_lo <= key <= pz.key_hi):
            continue
        for z in zones:
            if z.key_lo <= key <= z.key_hi:
                cand.append((_zone_plus_preset(z, pz.rel),
                             max(pz.vel_lo, z.vel_lo),
                             min(pz.vel_hi, z.vel_hi)))
    if not cand:
        return None
    renders: dict[int, np.ndarray | None] = {}

    def render(i):
        if i not in renders:
            renders[i] = _render_zone(sf, cand[i][0], key, sr)
        return renders[i]

    groups: dict[tuple, int] = {}
    samples: list[np.ndarray] = []
    lut = np.full(128, -1, np.int32)
    for vel in range(128):
        sel = tuple(i for i, (z, vlo, vhi) in enumerate(cand)
                    if vlo <= vel <= vhi and render(i) is not None)
        if not sel:
            continue
        if sel not in groups:
            parts = [renders[i] for i in sel]
            n = max(len(p) for p in parts)
            acc = np.zeros(n, np.float32)
            for p in parts:
                acc[: len(p)] += p
            groups[sel] = len(samples)
            samples.append(acc)
        lut[vel] = groups[sel]
    return (samples, lut) if samples else None


@functools.lru_cache(maxsize=16)
def kit_from_sf2(path: str, sr: int = 44100) -> DrumKit:
    """Velocity-layered sample table in HVO voice order from a .sf2's
    percussion preset (:class:`..drumkit.DrumKit`).

    Voices whose key has no zone fall back to the procedural kit's sample for
    that voice (so partial drum soundfonts still render every voice).
    Normalization is *kit-wide* (one factor scales every rendered zone to a
    0.9 max peak) so initialAttenuation and velocity-layer level
    relationships survive — per-sample normalization would erase them.
    """
    from .drumkit import default_kit

    fallback = default_kit(sr)  # internal code: its bugs must NOT be
    # reported as a malformed input file, so it stays outside the guard
    # below. Malformed .sf2 content must fail as SF2Error (a ValueError),
    # never leak an IndexError/struct.error/ZeroDivisionError from
    # inconsistent bag/gen/sample tables, nor a bare ValueError from numpy
    # on a truncated chunk (the JAX copy lets that one through) — the same
    # never-crash-ungracefully contract as the SMF parser (data/midi.py).
    n_voices = len(VOICE_TO_MIDI_NOTE)
    try:
        sf = parse_sf2(path)
        preset_entries = [
            (pz, _zones_for_instrument(sf, pz.instrument))
            for pz in _preset_zones(sf)
            if pz.instrument < len(sf["inst"])
        ]
        per_voice_layers = {}
        for voice, key in enumerate(VOICE_TO_MIDI_NOTE):
            layers = _layers_for_key(sf, preset_entries, key, sr)
            if layers is not None:
                per_voice_layers[voice] = layers
    except SF2Error:
        raise
    except (struct.error, IndexError, KeyError, ZeroDivisionError,
            OverflowError, FloatingPointError, ValueError) as e:
        raise SF2Error(f"malformed SoundFont {path}: {e!r}") from e

    # kit-wide normalization over the .sf2-rendered zones
    peaks = [float(np.max(np.abs(s)))
             for _, (samples, _) in per_voice_layers.items() for s in samples]
    kit_peak = max((p for p in peaks if p > 1e-6), default=0.0)
    scale = 0.9 / kit_peak if kit_peak > 1e-6 else 1.0

    flat: list[np.ndarray] = []
    silence = None
    lut = np.zeros((n_voices, 128), np.int32)
    per_voice = []
    for voice in range(n_voices):
        if voice in per_voice_layers:
            samples, lut128 = per_voice_layers[voice]
            base = len(flat)
            flat.extend(np.ascontiguousarray(scale * s, np.float32)
                        for s in samples)
            # velocities no zone covers render silence (fluidsynth behavior)
            if (lut128 < 0).any():
                if silence is None:
                    silence = len(flat)
                    flat.append(np.zeros(1, np.float32))
                lut[voice] = np.where(lut128 >= 0, base + lut128, silence)
            else:
                lut[voice] = base + lut128
        else:
            idx = len(flat)
            flat.append(np.ascontiguousarray(fallback[voice], np.float32))
            lut[voice] = idx
        per_voice.append(flat[lut[voice, 127]])
    return DrumKit(per_voice, flat, lut)


def write_minimal_sf2(path: str, samples: dict | None = None,
                      sr: int = 44100, name: str = "TGI Kit",
                      instruments: list | None = None):
    """Write a minimal valid percussion SoundFont — used for test fixtures
    and to export the procedural kit as .sf2.

    ``samples`` maps MIDI key → either a waveform array (one full-velocity
    zone rooted at the key, legacy form) or a list of zone dicts for
    generator-model fixtures::

        {"sample": arr,                 # required
         "vel_lo": 0, "vel_hi": 127,    # velRange (gen 44)
         "atten_cb": 0,                 # initialAttenuation (gen 48)
         "loop": (start, end) | None,   # sample loop + sampleModes=1 (gen 54)
         "root": key,                   # overridingRootKey (gen 58)
         "delay_tc"/"attack_tc"/"hold_tc"/"decay_tc"/
         "sustain_cb"/"release_tc": ...,   # volume envelope (gens 33-38)
         "filter_fc": 13500, "filter_q_cb": 0,  # voice lowpass (gens 8/9)
         "pan": 0,                         # pan, -500..500 (gen 17)
         "mod_env_to_filter_fc": 0,        # filter sweep depth, cents (11)
         "delay_modenv_tc"/"attack_modenv_tc"/"hold_modenv_tc"/
         "decay_modenv_tc"/"sustain_modenv"/"release_modenv_tc": ...,
                                           # modulation envelope (25-30)
         "delay_modlfo_tc"/"freq_modlfo"/"delay_viblfo_tc"/"freq_viblfo":
         ...,                              # LFOs (21-24)
         "mod_lfo_to_pitch"/"vib_lfo_to_pitch"/"mod_lfo_to_filter_fc"/
         "mod_lfo_to_volume": 0}           # LFO routings (5/6/10/13)

    ``instruments`` (mutually exclusive with ``samples``) builds a
    multi-instrument preset for preset-zone fixtures: a list of
    ``{"samples": {key: ...}, "key_lo": 0, "key_hi": 127,
    "vel_lo": 0, "vel_hi": 127}`` — each entry becomes its own instrument
    reached through a preset zone carrying those key/vel ranges. An entry
    may also carry preset-level relative value generators (spec §9.4) as
    the same field names as zone dicts (``atten_cb``, ``filter_fc``,
    ``filter_q_cb``, ``pan``, envelope fields): they are written as
    preset-zone generators and add to the instrument zones' values.
    """
    if (samples is None) == (instruments is None):
        raise ValueError("pass exactly one of samples= or instruments=")
    if instruments is None:
        instruments = [{"samples": samples}]

    # per instrument: flatten {key: zones} into ordered (key, zone) specs
    inst_zone_specs: list[list[tuple[int, dict]]] = []
    for spec in instruments:
        zone_specs: list[tuple[int, dict]] = []
        for key in sorted(spec["samples"]):
            val = spec["samples"][key]
            if isinstance(val, (list, tuple)):
                for z in val:
                    zone_specs.append((key, dict(z)))
            else:
                zone_specs.append((key, {"sample": val}))
        inst_zone_specs.append(zone_specs)

    pool = []
    shdr_entries = []
    pos = 0
    for zone_specs in inst_zone_specs:
        for key, z in zone_specs:
            pcm = np.clip(np.asarray(z["sample"], np.float32), -1, 1)
            pcm16 = (pcm * 32767).astype("<i2")
            pool.append(pcm16)
            pool.append(np.zeros(46, "<i2"))  # spec: 46 zeros after sample
            loop = z.get("loop")
            if loop is not None:
                loop_abs = (pos + int(loop[0]), pos + int(loop[1]))
            else:
                loop_abs = (pos, max(pos + len(pcm16) - 1, pos))
            shdr_entries.append(
                (pos, pos + len(pcm16), loop_abs, sr, z.get("root", key)))
            pos += len(pcm16) + 46
    smpl = np.concatenate(pool) if pool else np.zeros(0, "<i2")

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\0" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def zstr(s: str, n: int) -> bytes:
        b = s.encode()[: n - 1]
        return b + b"\0" * (n - len(b))

    # INFO
    info = chunk(b"LIST", b"INFO"
                 + chunk(b"ifil", struct.pack("<HH", 2, 1))
                 + chunk(b"isng", zstr("EMU8000", 8))
                 + chunk(b"INAM", zstr(name, 20)))
    sdta = chunk(b"LIST", b"sdta" + chunk(b"smpl", smpl.tobytes()))

    # pdta: one preset (bank 128, preset 0) → one preset zone per instrument
    # (with optional key/vel ranges) → zone per key within each instrument
    phdr = (struct.pack("<20sHHHIII", zstr("DrumKit", 20), 0, 128, 0, 0, 0, 0)
            + struct.pack("<20sHHHIII", zstr("EOP", 20), 0, 0,
                          len(instruments), 0, 0, 0))
    pbag = b""
    pgen = b""
    n_pgens = 0
    for i, spec in enumerate(instruments):
        pbag += struct.pack("<HH", n_pgens, 0)
        pzgens: list[bytes] = []
        klo, khi = spec.get("key_lo", 0), spec.get("key_hi", 127)
        vlo, vhi = spec.get("vel_lo", 0), spec.get("vel_hi", 127)
        if (klo, khi) != (0, 127):
            pzgens.append(struct.pack("<HH", _GEN_KEY_RANGE,
                                      klo | (khi << 8)))
        if (vlo, vhi) != (0, 127):
            pzgens.append(struct.pack("<HH", _GEN_VEL_RANGE,
                                      vlo | (vhi << 8)))
        # preset-level relative value generators (spec §9.4): deltas added to
        # the instrument zones' values; must precede the instrument gen
        for oper, field in _PRESET_REL_FIELDS.items():
            if field in spec:
                pzgens.append(struct.pack("<Hh", oper, int(spec[field])))
        pzgens.append(struct.pack("<Hh", _GEN_INSTRUMENT, i))
        pgen += b"".join(pzgens)
        n_pgens += len(pzgens)
    pbag += struct.pack("<HH", n_pgens, 0)
    pmod = b"\0" * 10
    inst = b""
    ibag = b""
    igen = b""
    n_gens = 0
    n_bags = 0
    sample_i = 0
    for ii, zone_specs in enumerate(inst_zone_specs):
        inst += struct.pack("<20sH", zstr(f"Drums{ii}", 20), n_bags)
        for key, z in zone_specs:
            ibag += struct.pack("<HH", n_gens, 0)
            n_bags += 1
            # generator order per spec: keyRange first, velRange second,
            # sampleID last
            gens: list[bytes] = [
                struct.pack("<HH", _GEN_KEY_RANGE, key | (key << 8))]
            vel_lo, vel_hi = z.get("vel_lo", 0), z.get("vel_hi", 127)
            if (vel_lo, vel_hi) != (0, 127):
                gens.append(struct.pack("<HH", _GEN_VEL_RANGE,
                                        vel_lo | (vel_hi << 8)))
            for oper, field in sorted(
                    {**_ENV_GEN_FIELDS,
                     _GEN_INITIAL_FILTER_FC: "filter_fc",
                     _GEN_INITIAL_FILTER_Q: "filter_q_cb",
                     _GEN_PAN: "pan"}.items()):
                if field in z:
                    gens.append(struct.pack("<Hh", oper, int(z[field])))
            if z.get("atten_cb"):
                gens.append(struct.pack("<Hh", _GEN_INITIAL_ATTENUATION,
                                        int(z["atten_cb"])))
            if z.get("loop") is not None:
                gens.append(struct.pack("<Hh", _GEN_SAMPLE_MODES, 1))
            gens.append(struct.pack("<Hh", _GEN_OVERRIDING_ROOT_KEY,
                                    int(z.get("root", key))))
            gens.append(struct.pack("<Hh", _GEN_SAMPLE_ID, sample_i))
            sample_i += 1
            igen += b"".join(gens)
            n_gens += len(gens)
    inst += struct.pack("<20sH", zstr("EOI", 20), n_bags)
    ibag += struct.pack("<HH", n_gens, 0)
    imod = b"\0" * 10
    shdr = b""
    for i, (start, end, loop_abs, rate, root) in enumerate(shdr_entries):
        shdr += struct.pack("<20sIIIIIBbHH", zstr(f"smp{i}", 20),
                            start, end, loop_abs[0], loop_abs[1], rate,
                            root, 0, 0, 1)
    shdr += struct.pack("<20sIIIIIBbHH", zstr("EOS", 20), 0, 0, 0, 0, 0, 0, 0,
                        0, 0)
    pdta = chunk(b"LIST", b"pdta"
                 + chunk(b"phdr", phdr) + chunk(b"pbag", pbag)
                 + chunk(b"pmod", pmod) + chunk(b"pgen", pgen)
                 + chunk(b"inst", inst) + chunk(b"ibag", ibag)
                 + chunk(b"imod", imod) + chunk(b"igen", igen)
                 + chunk(b"shdr", shdr))

    body = b"sfbk" + info + sdta + pdta
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path
