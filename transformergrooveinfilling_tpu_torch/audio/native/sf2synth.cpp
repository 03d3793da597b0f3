// Native sample-accumulation synthesizer core of the host audio path.
//
// Given a per-row sample table and a flat event list (row, onset sample
// index, gain), mix every event into the output buffer; plus the two DSP
// helpers the SoundFont reader (../sf2.py) renders its zones with. Plain
// contiguous float math with no allocation. The same arithmetic, in the same
// order, as the JAX package's audio/native/sf2synth.cpp, so both libraries
// give the same bits; tgi_biquad here also takes and returns its filter
// state, so a time-varying filter can run block by block through it.
//
// C ABI, loaded with ctypes by ../native_binding.py, which builds this file
// with g++ at first use:
//   tgi_mix_events      — mix one loop's events into one buffer
//   tgi_mix_batch       — mix a batch of loops (events grouped per item)
//   tgi_biquad          — one direct-form-I biquad section, state in and out
//   tgi_resample_linear — linear-interpolation resampler (SF2 pitch and rate)

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Mix `n_events` events into `buf` (length `buf_len`). `samples` is a table of
// `n_voices` pointers with lengths `sample_lens`; events index that table.
// Events with a row outside the table or an onset outside the buffer are
// skipped.
void tgi_mix_events(float* buf, int64_t buf_len,
                    const float* const* samples, const int64_t* sample_lens,
                    int64_t n_voices,
                    const int32_t* voices, const int64_t* onsets,
                    const float* vels, int64_t n_events) {
    for (int64_t e = 0; e < n_events; ++e) {
        const int32_t voice = voices[e];
        if (voice < 0 || voice >= n_voices) continue;
        const float* s = samples[voice];
        const int64_t s_len = sample_lens[voice];
        const int64_t onset = onsets[e];
        if (onset < 0 || onset >= buf_len) continue;
        const int64_t n = std::min(s_len, buf_len - onset);
        const float vel = vels[e];
        float* out = buf + onset;
        for (int64_t i = 0; i < n; ++i) {
            out[i] += vel * s[i];
        }
    }
}

// Batched variant: `buf` is (n_items, buf_len) row-major; `event_offsets`
// (n_items + 1) delimits each item's slice of the flat event arrays. Items
// write disjoint rows, so `n_threads > 1` splits the batch across
// std::threads; 0 or 1 runs inline. Several kits in one batch are one table:
// the caller concatenates their samples and offsets the rows into it.
void tgi_mix_batch(float* buf, int64_t n_items, int64_t buf_len,
                   const float* const* samples, const int64_t* sample_lens,
                   int64_t n_voices,
                   const int32_t* voices, const int64_t* onsets,
                   const float* vels, const int64_t* event_offsets,
                   int32_t n_threads) {
    auto run_range = [&](int64_t lo, int64_t hi) {
        for (int64_t item = lo; item < hi; ++item) {
            const int64_t start = event_offsets[item];
            const int64_t end = event_offsets[item + 1];
            tgi_mix_events(buf + item * buf_len, buf_len,
                           samples, sample_lens, n_voices,
                           voices + start, onsets + start, vels + start,
                           end - start);
        }
    };
    if (n_threads <= 1 || n_items <= 1) {
        run_range(0, n_items);
        return;
    }
    const int64_t t = std::min<int64_t>(n_threads, n_items);
    std::vector<std::thread> pool;
    pool.reserve(t);
    const int64_t per = (n_items + t - 1) / t;
    for (int64_t i = 0; i < t; ++i) {
        const int64_t lo = i * per;
        const int64_t hi = std::min(n_items, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(run_range, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// Direct-form-I biquad, in place: y[i] = b0 x[i] + b1 x[i-1] + b2 x[i-2]
//                                        - a1 y[i-1] - a2 y[i-2]
// in double, each output rounded to float. Coefficients are normalised by a0
// by the caller. `state` holds (x[-1], x[-2], y[-1], y[-2]) on entry and the
// section's last two inputs and outputs on return, so consecutive blocks
// through this call equal one pass over their concatenation.
void tgi_biquad(float* x, int64_t n,
                double b0, double b1, double b2, double a1, double a2,
                double* state) {
    double x1 = state[0], x2 = state[1], y1 = state[2], y2 = state[3];
    for (int64_t i = 0; i < n; ++i) {
        const double x0 = static_cast<double>(x[i]);
        const double y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
        x[i] = static_cast<float>(y0);
        x2 = x1; x1 = x0;
        y2 = y1; y1 = y0;
    }
    state[0] = x1; state[1] = x2; state[2] = y1; state[3] = y2;
}

// Linear-interpolation resampling: `ratio` = source samples advanced per
// output sample (sample-rate conversion and pitch shift together). Returns
// the number of output samples written (<= out_len).
int64_t tgi_resample_linear(const float* src, int64_t src_len,
                            float* out, int64_t out_len, double ratio) {
    if (src_len <= 1 || ratio <= 0.0) return 0;
    int64_t n = std::min<int64_t>(
        out_len, static_cast<int64_t>((src_len - 1) / ratio));
    double pos = 0.0;
    for (int64_t i = 0; i < n; ++i, pos += ratio) {
        const int64_t i0 = static_cast<int64_t>(pos);
        const double frac = pos - static_cast<double>(i0);
        out[i] = static_cast<float>(
            src[i0] * (1.0 - frac) + src[i0 + 1] * frac);
    }
    return n;
}

}  // extern "C"
