/* Native data-plane kernels for the host feature pipeline (the port's own
 * copy of goctr_tpu/native/fnv.c; host C, no device code).
 *
 * String hashing is the per-sample hot loop of feature assembly (the
 * reference: Go hash/fnv in HashOneHot32, feature/multihot.go:26-49 —
 * compiled Go; the Python loop is ~50x slower, so this tier restores
 * compiled-language speed), and the row gathers write the assembled sample
 * matrix straight into place.
 *
 * Strings arrive as one packed UTF-8 buffer + (n+1) offsets, so the ctypes
 * boundary moves two pointers instead of n PyObjects. Counts, widths,
 * strides and offsets are int64_t; the Python wrappers (native/hashing.py)
 * declare every function's argument types and check dtypes, contiguity,
 * bucket sizes and every gather index against its source's rows before
 * the call: nothing here checks.
 *
 * Build: cc -O3 -shared -fPIC -pthread fnv.c (native/build.py, at first
 * use, into goctr_tpu_torch/_build/)
 */
#include <stdint.h>
#include <stddef.h>

#define FNV_OFFSET32 0x811C9DC5u
#define FNV_PRIME32 0x01000193u

static inline uint32_t fnv1_32(const uint8_t *p, int64_t len) {
    uint32_t h = FNV_OFFSET32;
    for (int64_t i = 0; i < len; i++) {
        h *= FNV_PRIME32;
        h ^= p[i];
    }
    return h;
}

static inline uint32_t fnv1a_32(const uint8_t *p, int64_t len) {
    uint32_t h = FNV_OFFSET32;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= FNV_PRIME32;
    }
    return h;
}

/* out[i] = fnv1_32(buf[offsets[i]:offsets[i+1]]) */
void fnv1_32_batch(const uint8_t *buf, const int64_t *offsets, int64_t n,
                   uint32_t *out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = fnv1_32(buf + offsets[i], offsets[i + 1] - offsets[i]);
}

void fnv1a_32_batch(const uint8_t *buf, const int64_t *offsets, int64_t n,
                    uint32_t *out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = fnv1a_32(buf + offsets[i], offsets[i + 1] - offsets[i]);
}

/* out[i] = fnv1_32(value_i) % size  (HashOneHot32 bucket assignment) */
void hash_bucket_batch(const uint8_t *buf, const int64_t *offsets, int64_t n,
                       int32_t size, int32_t *out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = (int32_t)(fnv1_32(buf + offsets[i],
                                   offsets[i + 1] - offsets[i]) %
                           (uint32_t)size);
}

/* Dense multi-hot rows: for each input string, split on `sep`, lowercase
 * each token (ASCII; multi-byte UTF-8 passes through unchanged, matching
 * Go strings.ToLower for ASCII genre data), set out[i*size + bucket] = 1.
 * (StringSplitMultiHot multihot.go:37-49.) out must be zeroed by caller. */
void multihot_batch(const uint8_t *buf, const int64_t *offsets, int64_t n,
                    uint8_t sep, int32_t size, float *out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = buf + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        int64_t start = 0;
        for (int64_t j = 0; j <= len; j++) {
            if (j == len || p[j] == sep) {
                uint32_t h = FNV_OFFSET32;
                for (int64_t k = start; k < j; k++) {
                    uint8_t c = p[k];
                    if (c >= 'A' && c <= 'Z') c += 32;
                    h *= FNV_PRIME32;
                    h ^= c;
                }
                out[i * size + (int32_t)(h % (uint32_t)size)] = 1.0f;
                start = j + 1;
            }
        }
    }
}

/* Row gather+concat: X[r] = concat(blockA[idxA[r]], blockB[idxB[r]], ...)
 * expressed as a single generic primitive: copy rows of `src` (row width w)
 * selected by idx into the strided destination at column offset `col`.
 * Drives batched sample assembly (rcmd.go:375-397's goroutine fan-out
 * becomes one C pass per feature block). */
#include <pthread.h>
#include <string.h>

typedef struct {
    const float *src; const int64_t *idx;
    int64_t n0, n1, w, L, d;
    float *dst; int64_t dst_stride, col;
} gr_args;

static void *gr_worker(void *p) {
    gr_args *a = (gr_args *)p;
    for (int64_t r = a->n0; r < a->n1; r++) {
        const float *s = a->src + a->idx[r] * a->w;
        float *d = a->dst + r * a->dst_stride + a->col;
        memcpy(d, s, a->w * sizeof(float));
    }
    return 0;
}

/* emb-sequence gather: dst[r, col + l*d : ...] = emb[idx[r*L + l]] —
 * writes the whole behavior-embedding block of a sample row directly into
 * the strided output (no [n, L*d] intermediate; the r5 assembly profile
 * measured the intermediate + recopy as the full-scale wall). Negative
 * idx writes zeros. */
static void *ge_worker(void *p) {
    gr_args *a = (gr_args *)p;
    for (int64_t r = a->n0; r < a->n1; r++) {
        float *d = a->dst + r * a->dst_stride + a->col;
        const int64_t *ix = a->idx + r * a->L;
        for (int64_t l = 0; l < a->L; l++) {
            if (ix[l] >= 0)
                memcpy(d + l * a->d, a->src + ix[l] * a->d,
                       a->d * sizeof(float));
            else
                memset(d + l * a->d, 0, a->d * sizeof(float));
        }
    }
    return 0;
}

#define GR_THREADS 2

static void run_split(void *(*fn)(void *), gr_args *base, int64_t n) {
    if (n < (1 << 19)) {                  /* small: serial */
        base->n0 = 0; base->n1 = n;
        fn(base);
        return;
    }
    pthread_t tid[GR_THREADS];
    gr_args args[GR_THREADS];
    int64_t per = n / GR_THREADS;
    for (int t = 0; t < GR_THREADS; t++) {
        args[t] = *base;
        args[t].n0 = t * per;
        args[t].n1 = (t == GR_THREADS - 1) ? n : (t + 1) * per;
        pthread_create(&tid[t], 0, fn, &args[t]);
    }
    for (int t = 0; t < GR_THREADS; t++) pthread_join(tid[t], 0);
}

void gather_rows(const float *src, const int64_t *idx, int64_t n,
                 int64_t w, float *dst, int64_t dst_stride, int64_t col) {
    gr_args a = {src, idx, 0, n, w, 0, 0, dst, dst_stride, col};
    run_split(gr_worker, &a, n);
}

void gather_emb_rows(const float *emb, const int64_t *idx, int64_t n,
                     int64_t L, int64_t d, float *dst, int64_t dst_stride,
                     int64_t col) {
    gr_args a = {emb, idx, 0, n, 0, L, d, dst, dst_stride, col};
    run_split(ge_worker, &a, n);
}
