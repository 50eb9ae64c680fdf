/* CABAC binary arithmetic encoder core (H.265 9.3.4) — shared between the
 * op-stream backend (cabac.c) and the full-frame CU-tree emitter
 * (emitter.c). All functions are static so each translation unit gets its
 * own copy; behaviour is bit-exact with the Python reference backend
 * (svt_hevc_tpu/bitstream/cabac.py), test-enforced.
 */

#ifndef SVT_HEVC_TPU_CABAC_CORE_H
#define SVT_HEVC_TPU_CABAC_CORE_H

#include <stdint.h>
#include <string.h>

static const uint8_t range_tab_lps[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
    {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2},
};

static const uint8_t trans_idx_lps[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
    22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
    35,35,35,36,36,36,37,37,37,38,38,63,
};

static const uint8_t renorm_table[32] = {
    6,5,4,4,3,3,3,3,2,2,2,2,2,2,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
};

typedef struct {
    uint64_t low;
    int32_t range;
    int32_t bits_left;
    int32_t num_buffered;
    int32_t buffered_byte;
    uint8_t *buf;
    int64_t pos;
    int64_t cap;
} bac_t;

static void bac_init(bac_t *b, uint8_t *out, int64_t cap) {
    b->low = 0;
    b->range = 510;
    b->bits_left = 23;
    b->num_buffered = 0;
    b->buffered_byte = 0xFF;
    b->buf = out;
    b->pos = 0;
    b->cap = cap;
}

static void write_out(bac_t *b) {
    int32_t lead = (int32_t)(b->low >> (24 - b->bits_left));
    b->bits_left += 8;
    b->low &= (1ULL << (32 - b->bits_left)) - 1;
    if (lead == 0xFF) {
        b->num_buffered++;
    } else if (b->num_buffered > 0) {
        int32_t carry = lead >> 8;
        b->buf[b->pos++] = (uint8_t)(b->buffered_byte + carry);
        uint8_t fill = (uint8_t)(0xFF + carry);
        for (int32_t i = 0; i < b->num_buffered - 1; i++)
            b->buf[b->pos++] = fill;
        b->buffered_byte = lead & 0xFF;
        b->num_buffered = 1;
    } else {
        b->num_buffered = 1;
        b->buffered_byte = lead;
    }
}

static void encode_bin(bac_t *b, uint8_t *ctx, int32_t ctx_idx, int32_t binval) {
    int32_t state = ctx[ctx_idx];
    int32_t lps = range_tab_lps[state >> 1][(b->range >> 6) & 3];
    b->range -= lps;
    if (binval != (state & 1)) {
        int32_t nbits = renorm_table[lps >> 3];
        b->low = (b->low + (uint64_t)b->range) << nbits;
        b->range = lps << nbits;
        int32_t s = state >> 1;
        ctx[ctx_idx] = (uint8_t)(s == 0 ? (1 - (state & 1))
                                        : ((trans_idx_lps[s] << 1) | (state & 1)));
        b->bits_left -= nbits;
    } else {
        int32_t s = state >> 1;
        int32_t next = s < 62 ? s + 1 : 62;
        ctx[ctx_idx] = (uint8_t)((next << 1) | (state & 1));
        if (b->range >= 256)
            return;
        b->low <<= 1;
        b->range <<= 1;
        b->bits_left -= 1;
    }
    if (b->bits_left < 12)
        write_out(b);
}

static void encode_bypass(bac_t *b, int32_t binval) {
    b->low <<= 1;
    if (binval)
        b->low += (uint64_t)b->range;
    b->bits_left -= 1;
    if (b->bits_left < 12)
        write_out(b);
}

static void encode_bypass_bins(bac_t *b, int32_t nbits, int64_t value) {
    while (nbits > 8) {
        nbits -= 8;
        int64_t pattern = value >> nbits;
        b->low = (b->low << 8) + (uint64_t)(b->range * pattern);
        value -= pattern << nbits;
        b->bits_left -= 8;
        if (b->bits_left < 12)
            write_out(b);
    }
    if (nbits) {
        b->low = (b->low << nbits) + (uint64_t)(b->range * value);
        b->bits_left -= nbits;
        if (b->bits_left < 12)
            write_out(b);
    }
}

static void encode_terminate(bac_t *b, int32_t binval) {
    b->range -= 2;
    if (binval) {
        b->low += (uint64_t)b->range;
        b->low <<= 7;
        b->range = 2 << 7;
        b->bits_left -= 7;
    } else if (b->range >= 256) {
        return;
    } else {
        b->low <<= 1;
        b->range <<= 1;
        b->bits_left -= 1;
    }
    if (b->bits_left < 12)
        write_out(b);
}

static void bac_finish(bac_t *b) {
    if ((b->low >> (32 - b->bits_left)) != 0) {
        b->buf[b->pos++] = (uint8_t)(b->buffered_byte + 1);
        for (int32_t i = 0; i < b->num_buffered - 1; i++)
            b->buf[b->pos++] = 0x00;
        b->low -= 1ULL << (32 - b->bits_left);
    } else {
        if (b->num_buffered > 0)
            b->buf[b->pos++] = (uint8_t)b->buffered_byte;
        for (int32_t i = 0; i < b->num_buffered - 1; i++)
            b->buf[b->pos++] = 0xFF;
    }
    int32_t nbits = 24 - b->bits_left;
    int64_t val = nbits > 0 ? (int64_t)((b->low >> 8) & ((1ULL << nbits) - 1)) : 0;
    /* emit remaining bits MSB-first, then rbsp stop bit + alignment */
    int32_t total = nbits + 1;
    int32_t pad = (8 - (total % 8)) % 8;
    uint64_t bits = ((uint64_t)val << 1) | 1;   /* val bits + stop bit */
    bits <<= pad;
    total += pad;
    for (int32_t i = total - 8; i >= 0; i -= 8)
        b->buf[b->pos++] = (uint8_t)((bits >> i) & 0xFF);
}

#endif /* SVT_HEVC_TPU_CABAC_CORE_H */
