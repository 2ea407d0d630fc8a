/* Real-time watermark mixer: the latency-critical TX inner loop in C.
 *
 * The Python streaming path (models/embedder.py process()) is correct but
 * runs inside the PortAudio callback where GC pauses and NumPy dispatch
 * jitter eat into the ~21 ms block budget.  This native mixer owns a
 * lock-free single-producer/single-consumer chip ring buffer: the audio
 * thread calls mixer_process() (pure C, no allocation), while a Python
 * feeder thread refills chips with mixer_push_chips().
 *
 * The mix law matches the reference (embedder.py:44-75): per block,
 *   scale = max(alpha * rms(in), floor);
 *   scale = min(scale, max(headroom - peak(in), 0) / peak(chips));
 *   out = in + chips * scale.
 *
 * Built on first use by echoseal_torch/native/__init__.py:
 *   cc -O2 -shared -fPIC mixer.c -o _mixer-<hash>.so -lm
 */
#include <math.h>
#include <stdatomic.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    float *buf;
    size_t cap;                 /* power of two */
    _Atomic size_t head;        /* write index (producer: Python feeder) */
    _Atomic size_t tail;        /* read index (consumer: audio thread)  */
    float alpha;                /* 10^(target_rel_db/20)   */
    float floor_lin;            /* 10^(floor_rel_dbfs/20)  */
    float headroom;             /* MIX_HEADROOM            */
} mixer_t;

mixer_t *mixer_new(double target_rel_db, double floor_rel_dbfs,
                   double headroom, size_t capacity_pow2) {
    mixer_t *m = calloc(1, sizeof(mixer_t));
    if (!m) return NULL;
    m->cap = (size_t)1 << capacity_pow2;
    m->buf = malloc(m->cap * sizeof(float));
    if (!m->buf) { free(m); return NULL; }
    m->alpha = (float)pow(10.0, target_rel_db / 20.0);
    m->floor_lin = (float)pow(10.0, floor_rel_dbfs / 20.0);
    m->headroom = (float)headroom;
    return m;
}

void mixer_free(mixer_t *m) {
    if (m) { free(m->buf); free(m); }
}

size_t mixer_available(const mixer_t *m) {
    return atomic_load(&m->head) - atomic_load(&m->tail);
}

size_t mixer_space(const mixer_t *m) {
    return m->cap - mixer_available(m);
}

/* producer side: returns number of chips accepted */
size_t mixer_push_chips(mixer_t *m, const float *chips, size_t n) {
    size_t head = atomic_load_explicit(&m->head, memory_order_relaxed);
    size_t space = m->cap - (head - atomic_load(&m->tail));
    if (n > space) n = space;
    for (size_t i = 0; i < n; i++)
        m->buf[(head + i) & (m->cap - 1)] = chips[i];
    atomic_store_explicit(&m->head, head + n, memory_order_release);
    return n;
}

/* consumer side (audio thread): mixes n samples; returns chips consumed
 * (< n means the ring ran dry and the tail of out is passthrough). */
size_t mixer_process(mixer_t *m, const float *in, float *out, size_t n) {
    size_t tail = atomic_load_explicit(&m->tail, memory_order_relaxed);
    size_t avail = atomic_load_explicit(&m->head, memory_order_acquire) - tail;
    size_t take = n < avail ? n : avail;

    double acc = 0.0;
    float peak_in = 0.0f;
    for (size_t i = 0; i < n; i++) {
        float v = in[i];
        acc += (double)v * v;
        float a = fabsf(v);
        if (a > peak_in) peak_in = a;
    }
    float rms = (float)sqrt(acc / (n ? (double)n : 1.0)) + 1e-12f;

    float peak_c = 0.0f;
    for (size_t i = 0; i < take; i++) {
        float c = m->buf[(tail + i) & (m->cap - 1)];
        float a = fabsf(c);
        if (a > peak_c) peak_c = a;
    }
    peak_c += 1e-12f;

    float scale = m->alpha * rms;
    if (scale < m->floor_lin) scale = m->floor_lin;
    float headroom = m->headroom - peak_in;
    if (headroom < 0.0f) headroom = 0.0f;
    float cap = headroom / peak_c;
    if (scale > cap) scale = cap;

    for (size_t i = 0; i < take; i++)
        out[i] = in[i] + m->buf[(tail + i) & (m->cap - 1)] * scale;
    for (size_t i = take; i < n; i++)
        out[i] = in[i];

    atomic_store_explicit(&m->tail, tail + take, memory_order_release);
    return take;
}
