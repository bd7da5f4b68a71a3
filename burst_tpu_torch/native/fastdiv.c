/* fastdiv: bit-exact emulation of the reference binary's -Ofast
 * identity computation (observed in burst_linux v1.0 at 0x4168cd):
 *
 *     r0 = RCPPS(d)                ; hardware reciprocal estimate
 *     r  = 2*r0 - r0*r0*d          ; one Newton-Raphson step
 *     score = 1 - ed*r             ; all float32
 *
 * The RCPPS estimate is CPU-specific, so this must execute natively on
 * the same machine that produced the golden outputs. Compiled WITHOUT
 * fast-math so the surrounding mul/sub are IEEE like the binary's
 * vmulps/vsubps.
 *
 * Build: cc -O2 -msse -shared -fPIC -o fastdiv.so fastdiv.c
 */
#include <stddef.h>
#include <xmmintrin.h>

void score_rcp_nr(const float *ed, const float *d, float *out, long n) {
    for (long i = 0; i < n; ++i) {
        __m128 dv = _mm_set_ss(d[i]);
        float r0 = _mm_cvtss_f32(_mm_rcp_ss(dv));
        /* operand order matters for rounding: r0*(r0*d), not (r0*r0)*d */
        float r = (r0 + r0) - r0 * (r0 * d[i]);
        out[i] = 1.0f - ed[i] * r;
    }
}
