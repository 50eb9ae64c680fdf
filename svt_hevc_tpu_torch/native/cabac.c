/* CABAC binary arithmetic encoder, op-stream backend (H.265 9.3.4).
 *
 * Consumes a recorded op stream (see svt_hevc_tpu/bitstream/recorder.py):
 * the Python/TPU layers enumerate (kind, a, b) bin operations; this core
 * runs the sequential arithmetic coding in one call. Bit-exact with the
 * Python reference backend (svt_hevc_tpu/bitstream/cabac.py) — equivalence
 * is enforced by tests, the project analogue of the reference's
 * C-vs-assembly asm_test (Tests/SVT-HEVC_FunctionalTests.py:830).
 *
 * Op encoding, three int32 lanes per op:
 *   kind 0: context bin      a = ctx index, b = bin value
 *   kind 1: bypass bin       b = bin value
 *   kind 2: bypass bins      a = nbits,     b = value
 *   kind 3: terminate bin    b = bin value
 * finish() (EncodeFlush semantics incl. rbsp stop bit) runs after the ops.
 */

#include "cabac_core.h"

/* Encode a full op stream. Returns bytes written, or -1 on overflow risk. */
int64_t cabac_encode_ops(const int32_t *ops, int64_t n_ops, uint8_t *ctx,
                         uint8_t *out, int64_t out_cap) {
    bac_t b;
    bac_init(&b, out, out_cap);
    for (int64_t i = 0; i < n_ops; i++) {
        if (b.pos + b.num_buffered + 16 > out_cap)
            return -1;
        int32_t kind = ops[3 * i];
        int32_t a = ops[3 * i + 1];
        int32_t v = ops[3 * i + 2];
        switch (kind) {
        case 0: encode_bin(&b, ctx, a, v); break;
        case 1: encode_bypass(&b, v); break;
        case 2: encode_bypass_bins(&b, a, v); break;
        case 3: encode_terminate(&b, v); break;
        default: return -2;
        }
    }
    if (b.pos + b.num_buffered + 16 > out_cap)
        return -1;
    bac_finish(&b);
    return b.pos;
}
