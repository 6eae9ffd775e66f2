/* Per-lane CABAC kernel: the scalar range coder from cabac.py/binarization.py
 * transliterated to C, applied lane-by-lane over a batch of independent chunk
 * streams (the port's copy of repro/core/_cabac_lanes.c, the
 * temporal-context ("P-frame") variants included).  Compiled on demand by
 * repro_torch.core.cabac_vec with the host cc into build/host/ of the checkout and called through
 * ctypes; the numpy lockstep engine in cabac_vec.py is the portable
 * reference with identical semantics.  Host code: it never runs on the card.
 *
 * Bit-exactness contract: every arithmetic step below mirrors the Python
 * scalar coder exactly (LZMA-style 64-bit low / 32-bit range, carry
 * propagation, 12-bit probabilities, adaptation shift 5, zero bytes past the
 * end of a stream).  tests/test_torch_codec.py cross-checks the engines
 * per lane and against the reference package's bytes.
 */
#include <stdint.h>
#include <stddef.h>

#define PROB_BITS 12
#define PROB_ONE (1u << PROB_BITS)
#define PROB_HALF (PROB_ONE >> 1)
#define PROB_MIN 16u
#define PROB_MAX (PROB_ONE - PROB_MIN)
#define ADAPT_SHIFT 5
#define TOP (1u << 24)
#define MASK32 0xFFFFFFFFull

#define CTX_SIGN 2
#define CTX_GR_BASE 3
#define EG_CTXS 24
#define TEMPORAL_CLASSES 3
/* sized for the temporal-context mode: 3 * (3 + 255 + 24) = 846 contexts
 * at the u8 maximum of num_gr */
#define MAX_CTX 1024

/* ------------------------------------------------------------------ decode */

typedef struct {
    const uint8_t *data;
    size_t len, pos;
    uint32_t range, code;
    uint16_t *probs;
} Dec;

static inline uint8_t dec_next_byte(Dec *d) {
    return d->pos < d->len ? d->data[d->pos++] : 0;
}

static inline int dec_bin(Dec *d, int ctx) {
    uint32_t p1 = d->probs[ctx];
    uint32_t bound = (d->range >> PROB_BITS) * p1;
    int bit;
    if (d->code < bound) {
        bit = 1;
        d->range = bound;
        p1 += (PROB_ONE - p1) >> ADAPT_SHIFT;
        if (p1 > PROB_MAX) p1 = PROB_MAX;
    } else {
        bit = 0;
        d->code -= bound;
        d->range -= bound;
        p1 -= p1 >> ADAPT_SHIFT;
        if (p1 < PROB_MIN) p1 = PROB_MIN;
    }
    d->probs[ctx] = (uint16_t)p1;
    if (d->range < TOP) {
        d->range <<= 8;
        d->code = (d->code << 8) | dec_next_byte(d);
    }
    return bit;
}

static inline int dec_bypass(Dec *d) {
    d->range >>= 1;
    int bit = 0;
    if (d->code >= d->range) {
        d->code -= d->range;
        bit = 1;
    }
    if (d->range < TOP) {
        d->range <<= 8;
        d->code = (d->code << 8) | dec_next_byte(d);
    }
    return bit;
}

/* Decode n_lanes independent level streams.
 * data:    concatenated chunk payloads
 * doff:    [n_lanes + 1] byte offsets into data
 * out:     concatenated int64 outputs
 * ooff:    [n_lanes + 1] value offsets into out (count of lane l is
 *          ooff[l+1] - ooff[l])
 * Returns 0 on success, 1 when a stream carries an Exp-Golomb exponent
 * beyond the lane engines' |level| <= 2^61 - 1 range (the arbitrary-
 * precision scalar coder can produce these) — the caller falls back to
 * the scalar path instead of wrapping int64.
 */
int32_t cabac_decode_lanes(const uint8_t *data, const int64_t *doff,
                           int64_t *out, const int64_t *ooff,
                           int32_t n_lanes, int32_t num_gr) {
    int eg_base = CTX_GR_BASE + num_gr;
    int eg_last = eg_base + EG_CTXS - 1;
    int nctx = eg_base + EG_CTXS;
    uint16_t probs[MAX_CTX];
    if (nctx > MAX_CTX) return 2; /* unreachable: num_gr is a u8 */
    for (int32_t l = 0; l < n_lanes; l++) {
        Dec d;
        d.data = data + doff[l];
        d.len = (size_t)(doff[l + 1] - doff[l]);
        d.pos = 0;
        d.range = 0xFFFFFFFFu;
        d.code = 0;
        d.probs = probs;
        for (int i = 0; i < nctx; i++) probs[i] = PROB_HALF;
        for (int i = 0; i < 4; i++) d.code = (d.code << 8) | dec_next_byte(&d);
        int64_t count = ooff[l + 1] - ooff[l];
        int64_t *o = out + ooff[l];
        int prev_sig = 0;
        for (int64_t idx = 0; idx < count; idx++) {
            if (!dec_bin(&d, prev_sig)) {
                o[idx] = 0;
                prev_sig = 0;
                continue;
            }
            prev_sig = 1;
            int neg = dec_bin(&d, CTX_SIGN);
            int64_t a = 1;
            int j = 1;
            while (j <= num_gr) {
                if (dec_bin(&d, CTX_GR_BASE + j - 1)) {
                    a = j + 1;
                    j += 1;
                } else {
                    a = j;
                    break;
                }
            }
            if (j > num_gr) {
                int k = 0;
                for (;;) {
                    int c = eg_base + k;
                    if (c > eg_last) c = eg_last;
                    if (!dec_bin(&d, c)) break;
                    k += 1;
                    if (k > 60) return 1; /* level would exceed 2^61 - 1 */
                }
                uint64_t i2 = (uint64_t)1 << k;
                for (int b = 0; b < k; b++)
                    i2 |= (uint64_t)dec_bypass(&d) << (k - 1 - b);
                a = (int64_t)((uint64_t)num_gr + i2);
            }
            o[idx] = neg ? -a : a;
        }
    }
    return 0;
}

/* Temporal-context ("P-frame") variant of cabac_decode_lanes.
 * cls: concatenated per-value class ids, one byte each (same layout and
 * offsets as out via ooff); each value's context indices are offset by cls * nctx_intra into
 * one of TEMPORAL_CLASSES banks.  Classes are computed host-side from the
 * shared base frame, so encoder/decoder agreement is structural. */
int32_t cabac_decode_lanes_tc(const uint8_t *data, const int64_t *doff,
                              const uint8_t *cls, int64_t *out,
                              const int64_t *ooff, int32_t n_lanes,
                              int32_t num_gr) {
    int eg_base = CTX_GR_BASE + num_gr;
    int eg_last = eg_base + EG_CTXS - 1;
    int nctx1 = eg_base + EG_CTXS;
    int nctx = TEMPORAL_CLASSES * nctx1;
    uint16_t probs[MAX_CTX];
    if (nctx > MAX_CTX) return 2; /* unreachable: num_gr is a u8 */
    for (int32_t l = 0; l < n_lanes; l++) {
        Dec d;
        d.data = data + doff[l];
        d.len = (size_t)(doff[l + 1] - doff[l]);
        d.pos = 0;
        d.range = 0xFFFFFFFFu;
        d.code = 0;
        d.probs = probs;
        for (int i = 0; i < nctx; i++) probs[i] = PROB_HALF;
        for (int i = 0; i < 4; i++) d.code = (d.code << 8) | dec_next_byte(&d);
        int64_t count = ooff[l + 1] - ooff[l];
        int64_t *o = out + ooff[l];
        const uint8_t *cl = cls + ooff[l];
        int prev_sig = 0;
        for (int64_t idx = 0; idx < count; idx++) {
            int off = (int)cl[idx] * nctx1;
            if (!dec_bin(&d, off + prev_sig)) {
                o[idx] = 0;
                prev_sig = 0;
                continue;
            }
            prev_sig = 1;
            int neg = dec_bin(&d, off + CTX_SIGN);
            int64_t a = 1;
            int j = 1;
            while (j <= num_gr) {
                if (dec_bin(&d, off + CTX_GR_BASE + j - 1)) {
                    a = j + 1;
                    j += 1;
                } else {
                    a = j;
                    break;
                }
            }
            if (j > num_gr) {
                int k = 0;
                for (;;) {
                    int c = eg_base + k;
                    if (c > eg_last) c = eg_last;
                    if (!dec_bin(&d, off + c)) break;
                    k += 1;
                    if (k > 60) return 1; /* level would exceed 2^61 - 1 */
                }
                uint64_t i2 = (uint64_t)1 << k;
                for (int b = 0; b < k; b++)
                    i2 |= (uint64_t)dec_bypass(&d) << (k - 1 - b);
                a = (int64_t)((uint64_t)num_gr + i2);
            }
            o[idx] = neg ? -a : a;
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ encode */

typedef struct {
    uint8_t *out;
    int64_t n;
    uint64_t low;
    uint32_t range;
    uint32_t cache;
    int64_t cache_size;
    uint16_t *probs;
} Enc;

static inline void enc_shift_low(Enc *e) {
    if (e->low < 0xFF000000u || e->low > MASK32) {
        uint32_t carry = (uint32_t)(e->low >> 32);
        e->out[e->n++] = (uint8_t)(e->cache + carry);
        uint8_t filler = (uint8_t)(0xFFu + carry);
        for (int64_t i = 0; i < e->cache_size - 1; i++) e->out[e->n++] = filler;
        e->cache_size = 0;
        e->cache = (uint8_t)(e->low >> 24);
    }
    e->cache_size += 1;
    e->low = (e->low << 8) & MASK32;
}

static inline void enc_bin(Enc *e, int ctx, int bit) {
    uint32_t p1 = e->probs[ctx];
    uint32_t bound = (e->range >> PROB_BITS) * p1;
    if (bit) {
        e->range = bound;
        p1 += (PROB_ONE - p1) >> ADAPT_SHIFT;
        if (p1 > PROB_MAX) p1 = PROB_MAX;
    } else {
        e->low += bound;
        e->range -= bound;
        p1 -= p1 >> ADAPT_SHIFT;
        if (p1 < PROB_MIN) p1 = PROB_MIN;
    }
    e->probs[ctx] = (uint16_t)p1;
    if (e->range < TOP) {
        e->range <<= 8;
        enc_shift_low(e);
    }
}

static inline void enc_bypass(Enc *e, int bit) {
    e->range >>= 1;
    if (bit) e->low += e->range;
    if (e->range < TOP) {
        e->range <<= 8;
        enc_shift_low(e);
    }
}

/* Encode n_lanes level streams.
 * levels:  concatenated int64 inputs, loff: [n_lanes + 1] value offsets
 * out:     one buffer per lane at out + l * out_stride (caller sizes
 *          out_stride for the worst case); out_lens[l] receives the byte
 *          count INCLUDING the leading dummy zero byte the range coder
 *          emits (the caller drops out[l*stride], matching
 *          RangeEncoder.finish()).
 */
void cabac_encode_lanes(const int64_t *levels, const int64_t *loff,
                        uint8_t *out, int64_t out_stride, int64_t *out_lens,
                        int32_t n_lanes, int32_t num_gr) {
    int eg_base = CTX_GR_BASE + num_gr;
    int eg_last = eg_base + EG_CTXS - 1;
    int nctx = eg_base + EG_CTXS;
    uint16_t probs[MAX_CTX];
    if (nctx > MAX_CTX) return;
    for (int32_t l = 0; l < n_lanes; l++) {
        Enc e;
        e.out = out + (int64_t)l * out_stride;
        e.n = 0;
        e.low = 0;
        e.range = 0xFFFFFFFFu;
        e.cache = 0;
        e.cache_size = 1;
        e.probs = probs;
        for (int i = 0; i < nctx; i++) probs[i] = PROB_HALF;
        const int64_t *lv = levels + loff[l];
        int64_t count = loff[l + 1] - loff[l];
        int prev_sig = 0;
        for (int64_t idx = 0; idx < count; idx++) {
            int64_t v = lv[idx];
            if (v == 0) {
                enc_bin(&e, prev_sig, 0);
                prev_sig = 0;
                continue;
            }
            enc_bin(&e, prev_sig, 1);
            prev_sig = 1;
            enc_bin(&e, CTX_SIGN, v < 0 ? 1 : 0);
            uint64_t a = (uint64_t)(v < 0 ? -v : v);
            uint64_t j = 1;
            while (j <= (uint64_t)num_gr) {
                int gr = a > j ? 1 : 0;
                enc_bin(&e, CTX_GR_BASE + (int)j - 1, gr);
                if (!gr) break;
                j += 1;
            }
            if (a > (uint64_t)num_gr) {
                uint64_t i2 = a - (uint64_t)num_gr; /* >= 1 */
                int k = 63;
                while (!(i2 >> k)) k -= 1; /* floor(log2 i2) */
                for (int p = 0; p < k; p++) {
                    int c = eg_base + p;
                    if (c > eg_last) c = eg_last;
                    enc_bin(&e, c, 1);
                }
                int c = eg_base + k;
                if (c > eg_last) c = eg_last;
                enc_bin(&e, c, 0);
                uint64_t r = i2 - ((uint64_t)1 << k);
                for (int s = k - 1; s >= 0; s--) enc_bypass(&e, (int)((r >> s) & 1));
            }
        }
        for (int i = 0; i < 5; i++) enc_shift_low(&e);
        out_lens[l] = e.n;
    }
}

/* Temporal-context variant of cabac_encode_lanes; cls shares loff with
 * levels. */
void cabac_encode_lanes_tc(const int64_t *levels, const uint8_t *cls,
                           const int64_t *loff, uint8_t *out,
                           int64_t out_stride, int64_t *out_lens,
                           int32_t n_lanes, int32_t num_gr) {
    int eg_base = CTX_GR_BASE + num_gr;
    int eg_last = eg_base + EG_CTXS - 1;
    int nctx1 = eg_base + EG_CTXS;
    int nctx = TEMPORAL_CLASSES * nctx1;
    uint16_t probs[MAX_CTX];
    if (nctx > MAX_CTX) return;
    for (int32_t l = 0; l < n_lanes; l++) {
        Enc e;
        e.out = out + (int64_t)l * out_stride;
        e.n = 0;
        e.low = 0;
        e.range = 0xFFFFFFFFu;
        e.cache = 0;
        e.cache_size = 1;
        e.probs = probs;
        for (int i = 0; i < nctx; i++) probs[i] = PROB_HALF;
        const int64_t *lv = levels + loff[l];
        const uint8_t *cl = cls + loff[l];
        int64_t count = loff[l + 1] - loff[l];
        int prev_sig = 0;
        for (int64_t idx = 0; idx < count; idx++) {
            int off = (int)cl[idx] * nctx1;
            int64_t v = lv[idx];
            if (v == 0) {
                enc_bin(&e, off + prev_sig, 0);
                prev_sig = 0;
                continue;
            }
            enc_bin(&e, off + prev_sig, 1);
            prev_sig = 1;
            enc_bin(&e, off + CTX_SIGN, v < 0 ? 1 : 0);
            uint64_t a = (uint64_t)(v < 0 ? -v : v);
            uint64_t j = 1;
            while (j <= (uint64_t)num_gr) {
                int gr = a > j ? 1 : 0;
                enc_bin(&e, off + CTX_GR_BASE + (int)j - 1, gr);
                if (!gr) break;
                j += 1;
            }
            if (a > (uint64_t)num_gr) {
                uint64_t i2 = a - (uint64_t)num_gr; /* >= 1 */
                int k = 63;
                while (!(i2 >> k)) k -= 1; /* floor(log2 i2) */
                for (int p = 0; p < k; p++) {
                    int c = eg_base + p;
                    if (c > eg_last) c = eg_last;
                    enc_bin(&e, off + c, 1);
                }
                int c = eg_base + k;
                if (c > eg_last) c = eg_last;
                enc_bin(&e, off + c, 0);
                uint64_t r = i2 - ((uint64_t)1 << k);
                for (int s = k - 1; s >= 0; s--) enc_bypass(&e, (int)((r >> s) & 1));
            }
        }
        for (int i = 0; i < 5; i++) enc_shift_low(&e);
        out_lens[l] = e.n;
    }
}
